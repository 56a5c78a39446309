"""Loop closure: geometric verification + trajectory correction.

Replaces /root/reference/loop_closure.py. The reference re-loads the
raw loop-candidate images and re-runs its whole frontend on them
(close_loop, :8-16); here the keyframe store already holds the
candidate's triangulated features on device, so verification is one
Hamming match + RANSAC-PnP against the current frame's features —
no image re-processing.

Correction: the reference smears translation error linearly over the
intervening frames (:48-52). That fallback exists in
posegraph.distribute_error_linear; the primary path adds a loop edge
to the pose graph and relaxes it properly (models/posegraph.py).
A failed verification returns ok=False instead of the reference's
unguarded empty-list return (:33-36, crashes its caller).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam1_tpu.config import SlamConfig
from slam1_tpu.models.mapping import KeyframeStore
from slam1_tpu.ops import hamming
from slam1_tpu.ops.camera import StereoCamera
from slam1_tpu.ops.pnp import ransac_pnp


class LoopPairResult(NamedTuple):
    T_anchor_cand: jnp.ndarray   # (4,4) anchor camera from candidate camera
    anchor_frame: jnp.ndarray    # () int32 frame index of the anchor kf
    num_inliers: jnp.ndarray
    ok: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("cfg",))
def verify_loop_pair(key, store: KeyframeStore, cand_frame, hit_frame,
                     cam: StereoCamera, cfg: SlamConfig) -> LoopPairResult:
    """Keyframe-vs-keyframe loop verification (lag-tolerant).

    The asynchronous host poll may learn about a BoW hit tens of frames
    after it fired; by then the live camera no longer sees the revisited
    place, so verification against CURRENT (live-camera) features would
    fail. Both endpoints are instead taken from the keyframe store: the
    candidate keyframe's triangulated 3D points are matched against the
    2D keypoints of the nearest keyframe at-or-before `hit_frame` (the
    anchor) — the exact pair the hit was about. This also matches the
    reference's semantics: close_loop(idx, i) relocalizes the HIT frame
    i against candidate idx (/root/reference/loop_closure.py:7-32), not
    whatever frame the host got around to handling it on.
    """
    cand_frame = jnp.asarray(cand_frame).astype(jnp.int32)
    hit_frame = jnp.asarray(hit_frame).astype(jnp.int32)
    row = store.row_of_frame[
        jnp.clip(cand_frame, 0, store.row_of_frame.shape[0] - 1)]
    kf_idx = jnp.clip(row, 0, store.xyz.shape[0] - 1)
    kf_xyz = store.xyz[kf_idx]
    kf_desc = store.desc[kf_idx]
    kf_mask = store.mask[kf_idx] & (row >= 0) & (cand_frame >= 0)

    # Anchor: the newest keyframe whose frame index <= hit_frame.
    fo = store.frame_of_row                      # (F,) -1 for empty rows
    elig = (fo >= 0) & (fo <= hit_frame)
    a_row = jnp.argmax(jnp.where(elig, fo, -1))
    anchor_ok = jnp.any(elig)
    a_idx = jnp.clip(a_row, 0, store.xyz.shape[0] - 1)
    a_frame = jnp.where(anchor_ok, fo[a_idx], -1)
    a_desc = store.desc[a_idx]
    a_uv = store.uv[a_idx]
    a_mask = store.mask[a_idx] & anchor_ok & (a_frame != cand_frame)

    # Looser ratio than frame-to-frame matching: here precision comes
    # from the 1024-hypothesis RANSAC + min_loop_inliers gate, so the
    # descriptor stage should maximize RECALL — a strict global ratio
    # rejects true correspondences whose lookalikes sit elsewhere in
    # the snapshot, and loop pairs cannot use an epipolar/motion gate
    # (the relative pose is exactly what is being estimated).
    m = hamming.match(kf_desc, a_desc, kf_mask, a_mask,
                      ratio=min(cfg.matcher.ratio + 0.1, 0.95),
                      max_distance=cfg.matcher.max_hamming,
                      cross_check=cfg.matcher.cross_check)
    valid = m.mask & kf_mask
    uv_a = a_uv[m.idx]

    # Loop pairs are far harder than frame-to-frame tracking: an
    # offset revisit re-observes only a few % of the 1024-deep
    # snapshots, so the candidate-match inlier fraction is low and a
    # tracking-strength RANSAC (256 x 6-point) succeeds only ~half the
    # time — recall then flips on the PRNG key. 4-point minimal
    # samples raise the all-inlier hypothesis probability by ~an order
    # of magnitude and 1024 hypotheses amortize fine on a per-closure
    # cadence.
    import dataclasses as _dc
    loop_cfg = _dc.replace(cfg.tracking, ransac_iters=1024,
                           ransac_sample=4)
    pnp = ransac_pnp(key, kf_xyz, uv_a, valid, cam, loop_cfg)
    ok = (pnp.ok & anchor_ok
          & (pnp.num_inliers >= cfg.bow.min_loop_inliers))
    return LoopPairResult(T_anchor_cand=pnp.T, anchor_frame=a_frame,
                          num_inliers=pnp.num_inliers, ok=ok)


@functools.partial(jax.jit, static_argnames=("n_rows", "k", "thresh",
                                             "nms_frames"))
def place_query(store: KeyframeStore, q_row, max_frame, n_rows: int,
                k: int = 4, thresh: int = 48, nms_frames: int = 50):
    """Brute-force place recognition: match the query keyframe's
    descriptor snapshot against EVERY stored keyframe snapshot and
    score each by the number of query descriptors with a close match
    (Hamming <= thresh). Returns the top-k candidate frames
    (NMS-separated by >= nms_frames) and their scores.

    This replaces the quantized BoW histogram as the production
    retrieval path: a 64-word histogram collapses the descriptor
    population to 64 counts, and word assignments flip at Voronoi
    boundaries under view change — measured on the 2000-frame clip, the
    genuine revisit ranked 13-26th by histogram chi^2 (pure noise)
    while DIRECT descriptor matching puts it top-1 75% / top-4 83% of
    the time. The exhaustive product is affordable on the tensor
    cores: one (1024,256)x(256,1024) bf16 contraction per stored
    keyframe, ~0.5 TFLOP per query at a 1024-keyframe bucket,
    dispatched once per drain (not per frame). The same
    brute-force-beats-indexing argument
    as ops/hamming (vs the reference's FLANN) applied one level up
    (vs its BoW inverted scan, bag_of_words.py:29-42).

    `n_rows` is the static keyframe-row bucket (callers pick the
    smallest bucket >= kf.n); `max_frame` masks out frames newer than
    the query-exclusion horizon.
    """
    from slam1_tpu.ops.brief import unpack_bits_pm1
    q_desc = store.desc[q_row]
    q_mask = store.mask[q_row]
    qa = unpack_bits_pm1(q_desc).astype(jnp.bfloat16)      # (N,256)
    bits = qa.shape[1]

    # Scan in GROUPS of keyframes: one (N,256)x(256,G*K) contraction
    # per step instead of n_rows small matmuls, so per-step overheads
    # are paid n_rows/G times; G=8 keeps each step square-ish.
    G = min(8, n_rows)
    assert n_rows % G == 0, (n_rows, G)   # callers pass 2^k buckets
    n_groups = n_rows // G
    K = store.desc.shape[1]
    gd = store.desc[:n_groups * G].reshape(n_groups, G * K, -1)
    gm = store.mask[:n_groups * G].reshape(n_groups, G * K)

    def chunk(carry, fd):
        d_desc, d_mask = fd
        da = unpack_bits_pm1(d_desc).astype(jnp.bfloat16)  # (G*K,256)
        sim = jax.lax.dot_general(
            qa, da, (((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.DEFAULT,
            preferred_element_type=jnp.float32)            # (N,G*K)
        dist = (bits - sim) * 0.5
        dist = jnp.where(d_mask[None, :], dist, 1e9)
        dmin = jnp.min(dist.reshape(-1, G, K), axis=2)     # (N,G)
        score = jnp.sum(((dmin <= thresh) & q_mask[:, None])
                        .astype(jnp.float32), axis=0)      # (G,)
        return carry, score

    _, scores = jax.lax.scan(chunk, 0, (gd, gm))
    scores = scores.reshape(-1)[:n_rows]
    fo = store.frame_of_row[:n_rows]
    valid = (fo >= 0) & (fo <= max_frame)
    scores = jnp.where(valid, scores, -1.0)

    cands = []
    cscores = []
    for _ in range(k):
        b = jnp.argmax(scores)
        cands.append(jnp.where(scores[b] > 0, fo[b], -1))
        cscores.append(scores[b])
        scores = jnp.where(jnp.abs(fo - fo[b]) < nms_frames, -1.0,
                           scores)
    return jnp.stack(cands), jnp.stack(cscores)


@functools.partial(jax.jit, static_argnames=("cfg",))
def verify_loop_slate(keys, store: KeyframeStore, cand_frames,
                      hit_frames, cam: StereoCamera,
                      cfg: SlamConfig) -> LoopPairResult:
    """Batched loop verification: a whole (K,) slate of candidate/anchor
    pairs in ONE dispatched program (vmap of verify_loop_pair).

    One vmapped program and one packed (K,19) fetch per hit, instead
    of a program and a fetch per candidate. Entries with cand_frame < 0
    are padding (ok=False). Returns a LoopPairResult with a leading
    (K,) axis."""
    return jax.vmap(
        lambda k, c, h: verify_loop_pair(k, store, c, h, cam, cfg),
        in_axes=(0, 0, 0))(keys, jnp.asarray(cand_frames, jnp.int32),
                           jnp.asarray(hit_frames, jnp.int32))
