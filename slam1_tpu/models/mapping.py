"""Global map: fixed-capacity landmark table with voxel-hash dedup,
observation records, and keyframe feature snapshots.

Replaces the reference's unbounded Python map with per-frame KDTree
rebuild and O(n^2) vstack growth (/root/reference/keypoint.py:102-122,
main.py:124-127). Design: a pre-allocated landmark table plus an
open-addressed voxel hash (linear probing, `probes` slots); insertion
and merge are pure gather/scatter with masks — no dynamic shapes, no
host round-trips. A KD-tree is shape-dynamic and branchy; quantized
spatial hashing gives the same "merge if a nearby landmark exists"
semantics (ref keypoint.py:110-115) in O(probes) per point.

Known approximation (documented): if several NEW landmarks in one batch
hash to the same empty bucket, the last scatter wins the bucket and the
others stay valid in the table but unreachable via the hash — they can
be re-inserted as duplicates later. With 2^18 buckets at KITTI densities
this affects <<1% of points and only weakens dedup, never correctness.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from slam1_tpu.config import MappingConfig
from slam1_tpu.types import StereoObservations

# Large primes for the 3D voxel hash.
_P1, _P2, _P3 = 73856093, 19349669, 83492791


class MapState(NamedTuple):
    xyz: jnp.ndarray        # (CAP,3) world positions (running mean)
    desc: jnp.ndarray       # (CAP,D) uint8 descriptor of first observation
    count: jnp.ndarray      # (CAP,) int32 merged-observation count
    valid: jnp.ndarray      # (CAP,) bool
    hash_slot: jnp.ndarray  # (H+1,) int32 bucket -> landmark row, -1 empty;
                            # bucket H is a write-off scratch slot so masked
                            # scatters never clobber a real bucket
    cursor: jnp.ndarray     # () int32 next free row
    last_frame: jnp.ndarray # (CAP,) int32 frame of last observation
    # Observation records in fixed PER-FRAME slots [frame, landmark, u, v]
    # (+uv_r/stereo weight via `obs_ur`): a window of keyframes for local
    # BA is then a static slice of rows — no compaction, no host sync.
    obs: jnp.ndarray        # (F, OPF, 4) float32
    obs_ur: jnp.ndarray     # (F, OPF) float32 right-camera u (stereo term)
    obs_count: jnp.ndarray  # (F,) int32 filled slots per frame


def init_map(cfg: MappingConfig, desc_bytes: int = 32,
             dtype=jnp.float32) -> MapState:
    return MapState(
        xyz=jnp.zeros((cfg.capacity, 3), dtype),
        desc=jnp.zeros((cfg.capacity, desc_bytes), jnp.uint8),
        count=jnp.zeros((cfg.capacity,), jnp.int32),
        valid=jnp.zeros((cfg.capacity,), bool),
        hash_slot=jnp.full((cfg.hash_size + 1,), -1, jnp.int32),
        cursor=jnp.asarray(0, jnp.int32),
        last_frame=jnp.zeros((cfg.capacity,), jnp.int32),
        obs=jnp.zeros((cfg.max_frames, cfg.obs_per_frame, 4), dtype),
        obs_ur=jnp.zeros((cfg.max_frames, cfg.obs_per_frame), dtype),
        obs_count=jnp.zeros((cfg.max_frames,), jnp.int32),
    )


def _voxel_hash(xyz, voxel_size: float, hash_size: int):
    v = jnp.floor(xyz / voxel_size).astype(jnp.int32)
    h = (v[..., 0] * _P1) ^ (v[..., 1] * _P2) ^ (v[..., 2] * _P3)
    return jnp.abs(h) % hash_size


@functools.partial(jax.jit, static_argnames=("cfg",))
def insert(state: MapState, xyz_world, desc, mask, frame_idx, uv,
           cfg: MappingConfig, uv_r_u=None, obs_row=None,
           known_row=None) -> Tuple[MapState, jnp.ndarray]:
    """Merge-or-insert a batch of world points.

    Args:
      xyz_world: (N,3) points, desc: (N,D), mask: (N,), uv: (N,2) pixel
      observation in this frame (for the observation record).
      frame_idx: () int32 frame index (lifecycle bookkeeping: last_frame).
      uv_r_u: optional (N,) right-camera u coordinate (stereo BA term).
      obs_row: () int32 row of the observation table to append to
        (defaults to frame_idx; the pipeline passes the KEYFRAME row so
        windowed BA can slice keyframe rows statically).
      known_row: optional (N,) int32 landmark row each input is ALREADY
        associated with (-1 = unknown). The pipeline threads these
        through the temporal tracker's inlier matches, so a re-observed
        landmark keeps its identity via descriptor matching + RANSAC —
        far stronger data association than the 3D-radius hash merge,
        and the source of multi-frame co-visibility for BA.
    Returns:
      (new state, (N,) int32 landmark row of each input, -1 if dropped).
    """
    n = xyz_world.shape[0]
    # Hash grid: at least the merge-ball diameter, so that the ball
    # [x-r, x+r] spans at most 2 voxels per axis and probing the 8
    # corner voxels is guaranteed to cover every voxel intersecting it.
    # (A near-duplicate observed from the next frame routinely lands
    # across a voxel boundary; probing only the point's own voxel
    # misses it.)
    vs = max(cfg.voxel_size, 2.0 * cfg.merge_radius)
    h0 = _voxel_hash(xyz_world, vs, cfg.hash_size)

    r = cfg.merge_radius
    r2 = r * r
    lo = jnp.floor((xyz_world - r) / vs).astype(jnp.int32)
    hi = jnp.floor((xyz_world + r) / vs).astype(jnp.int32)

    # ONE batched probe over all 8 corner voxels x `probes` chain slots
    # (a serialized 32-iteration probe loop is 32 dependent passes over
    # device memory; a (N, 8*probes) gather is one).
    cx = jnp.stack([lo[:, 0], hi[:, 0]], -1)                 # (N,2)
    cy = jnp.stack([lo[:, 1], hi[:, 1]], -1)
    cz = jnp.stack([lo[:, 2], hi[:, 2]], -1)
    # corner-major order (cx,cy,cz) to match probe priority semantics
    hcor = ((cx[:, :, None, None] * _P1)
            ^ (cy[:, None, :, None] * _P2)
            ^ (cz[:, None, None, :] * _P3)).reshape(n, 8)    # (N,8)
    hcor = jnp.abs(hcor) % cfg.hash_size
    buckets = ((hcor[:, :, None] + jnp.arange(cfg.probes, dtype=jnp.int32))
               % cfg.hash_size).reshape(n, 8 * cfg.probes)   # (N,8P)
    slots = state.hash_slot[buckets]                          # (N,8P)
    occ = slots >= 0
    slots_c = jnp.maximum(slots, 0)
    cand = state.xyz[slots_c]                                 # (N,8P,3)
    near = occ & (jnp.sum((cand - xyz_world[:, None, :]) ** 2, -1) < r2)
    if cfg.merge_desc_gate > 0:
        # Appearance gate: positional proximity alone merges distinct
        # points under drift and feeds BA inconsistent tracks; require
        # descriptor agreement too.
        cd = state.desc[slots_c]                              # (N,8P,D)
        hd = jnp.sum(jax.lax.population_count(
            jnp.bitwise_xor(cd, desc[:, None, :])).astype(jnp.int32),
            axis=-1)
        near = near & (hd <= cfg.merge_desc_gate)
    first = jnp.argmax(near, axis=1)                          # (N,)
    hash_row = jnp.where(near.any(axis=1),
                         slots_c[jnp.arange(n), first], -1)
    # Track-inherited associations take priority over the hash probe.
    if known_row is not None:
        kr = jnp.asarray(known_row).astype(jnp.int32)
        k_ok = (kr >= 0) & (kr < state.xyz.shape[0])
        merge_row = jnp.where(k_ok, kr, hash_row)
    else:
        merge_row = hash_row
    # New landmarks are inserted on their OWN voxel's probe chain.
    b0 = ((h0[:, None] + jnp.arange(cfg.probes, dtype=jnp.int32))
          % cfg.hash_size)                                    # (N,P)
    vac = state.hash_slot[b0] < 0
    p0 = jnp.argmax(vac, axis=1)
    free_bucket = jnp.where(vac.any(axis=1),
                            b0[jnp.arange(n), p0], -1)

    is_merge = mask & (merge_row >= 0)
    is_new = mask & (merge_row < 0) & (free_bucket >= 0)

    # Allocate rows for inserts by exclusive prefix sum over the batch.
    new_flag = is_new.astype(jnp.int32)
    offsets = jnp.cumsum(new_flag) - new_flag
    new_row = state.cursor + offsets
    fits = new_row < state.xyz.shape[0]
    is_new = is_new & fits

    frame_i = jnp.asarray(frame_idx).astype(jnp.int32)
    cap_i = state.xyz.shape[0]
    ones = jnp.ones((n,), jnp.int32)
    # --- merges: running-mean position + count bump. A merge also
    # revives a culled landmark (re-observation = still useful).
    # Non-merge lanes scatter OOB with mode="drop": a duplicate-index
    # scatter-set with conflicting values is order-undefined in XLA, so
    # dumping them on row 0 could nondeterministically clobber a real
    # merge into row 0 (same clobber class as hash_slot's scratch
    # bucket / the obs slots).
    mrow_g = jnp.where(is_merge, merge_row, 0)            # gather index
    mrow_w = jnp.where(is_merge, merge_row, cap_i)        # scatter: drop
    count = state.count.at[mrow_w].add(ones, mode="drop")
    old_cnt = state.count[mrow_g].astype(xyz_world.dtype)
    new_cnt = jnp.maximum(old_cnt + 1.0, 1.0)
    delta = (xyz_world - state.xyz[mrow_g]) / new_cnt[:, None]
    xyz = state.xyz.at[mrow_w].add(delta, mode="drop")
    valid = state.valid.at[mrow_w].set(True, mode="drop")
    last_frame = state.last_frame.at[mrow_w].set(frame_i, mode="drop")

    # --- inserts.
    nrow_w = jnp.where(is_new, new_row, cap_i)            # scatter: drop
    xyz = xyz.at[nrow_w].set(xyz_world, mode="drop")
    desc_tbl = state.desc.at[nrow_w].set(desc, mode="drop")
    count = count.at[nrow_w].set(ones, mode="drop")
    valid = valid.at[nrow_w].set(True, mode="drop")
    last_frame = last_frame.at[nrow_w].set(frame_i, mode="drop")
    # Masked rows scatter into the scratch bucket H (never a real one —
    # bucket H-1 used to be silently clobberable).
    hbuck = jnp.where(is_new, free_bucket, cfg.hash_size)
    hash_slot = state.hash_slot.at[hbuck].set(
        jnp.where(is_new, new_row, state.hash_slot[hbuck]))
    hash_slot = hash_slot.at[cfg.hash_size].set(-1)
    cursor = state.cursor + jnp.sum(new_flag * fits.astype(jnp.int32))

    landmark_of = jnp.where(is_merge, merge_row,
                            jnp.where(is_new, new_row, -1))

    # --- observation records [frame, landmark, u, v] into this frame's
    # fixed slot row (static window slices for local BA).
    opf = state.obs.shape[1]
    orow = frame_i if obs_row is None else jnp.asarray(obs_row).astype(
        jnp.int32)
    frow = jnp.clip(orow, 0, state.obs.shape[0] - 1)
    base = state.obs_count[frow]
    has_obs = landmark_of >= 0
    oflag = has_obs.astype(jnp.int32)
    slot = base + jnp.cumsum(oflag) - oflag
    w = has_obs & (slot < opf)
    # Masked/overflow records get slot >= opf and are DROPPED by the
    # scatter mode (a write-back to a clipped slot could clobber a
    # legitimate record written by the same scatter).
    slot_c = jnp.where(w, slot, opf)
    rec = jnp.stack([
        frame_i.astype(xyz_world.dtype) * jnp.ones((n,), xyz_world.dtype),
        landmark_of.astype(xyz_world.dtype),
        uv[:, 0], uv[:, 1]], axis=-1)
    obs = state.obs.at[frow, slot_c].set(rec, mode="drop")
    if uv_r_u is None:
        uv_r_u = jnp.zeros((n,), xyz_world.dtype)
    obs_ur = state.obs_ur.at[frow, slot_c].set(uv_r_u, mode="drop")
    obs_count = state.obs_count.at[frow].set(
        base + jnp.sum(oflag * w.astype(jnp.int32)))

    return MapState(xyz=xyz, desc=desc_tbl, count=count, valid=valid,
                    hash_slot=hash_slot, cursor=cursor,
                    last_frame=last_frame, obs=obs, obs_ur=obs_ur,
                    obs_count=obs_count), landmark_of


@jax.jit
def cull(state: MapState, frame, min_obs, max_age) -> MapState:
    """Map-point culling (the lifecycle the reference only sketched,
    /root/reference/local_mapping.py:4 'Recent MapPoints culling'):
    invalidate landmarks observed fewer than `min_obs` times that
    haven't been seen for `max_age` frames. A later re-observation
    within merge radius revives them (see insert)."""
    frame = jnp.asarray(frame).astype(jnp.int32)
    stale = (state.valid & (state.count < min_obs)
             & (frame - state.last_frame > max_age))
    return state._replace(valid=state.valid & ~stale)


class KeyframeStore(NamedTuple):
    """Compact per-keyframe feature snapshots for loop closure /
    relocalization (the reference re-reads raw images instead,
    loop_closure.py:8-11 — we keep the top-K features on device)."""
    xyz: jnp.ndarray    # (F, K, 3) camera-frame 3D points
    desc: jnp.ndarray   # (F, K, D) uint8
    uv: jnp.ndarray     # (F, K, 2)
    mask: jnp.ndarray   # (F, K)
    poses: jnp.ndarray  # (F, 4, 4) world-from-camera at insertion time
    frame_of_row: jnp.ndarray  # (F,) int32 frame index of each keyframe
    row_of_frame: jnp.ndarray  # (F,) int32 keyframe row of a frame, -1
    n: jnp.ndarray      # () int32


def init_kf_store(max_frames: int, k: int, desc_bytes: int = 32,
                  dtype=jnp.float32) -> KeyframeStore:
    return KeyframeStore(
        xyz=jnp.zeros((max_frames, k, 3), dtype),
        desc=jnp.zeros((max_frames, k, desc_bytes), jnp.uint8),
        uv=jnp.zeros((max_frames, k, 2), dtype),
        mask=jnp.zeros((max_frames, k), bool),
        poses=jnp.tile(jnp.eye(4, dtype=dtype), (max_frames, 1, 1)),
        frame_of_row=jnp.full((max_frames,), -1, jnp.int32),
        row_of_frame=jnp.full((max_frames,), -1, jnp.int32),
        n=jnp.asarray(0, jnp.int32),
    )


@functools.partial(jax.jit, static_argnames=("k",))
def kf_insert(store: KeyframeStore, obs: StereoObservations, pose,
              k: int, frame=0, is_kf=True) -> KeyframeStore:
    """Keep the k best stereo observations of this frame, ranked by
    corner score (valid slots always outrank invalid ones).

    `is_kf` (traced bool) gates the insert: non-keyframes leave the
    store untouched (keyframe selection policy lives in the pipeline).
    """
    # Mask-gated score: every valid slot scores >= 1 + its FAST corner
    # response, every invalid slot scores -1 — so the snapshot keeps the
    # STRONGEST corners (loop verification then matches against the
    # most repeatable features, not an arbitrary valid subset).
    n = obs.mask.shape[0]
    scores = jnp.where(obs.mask, 1.0 + obs.score.astype(jnp.float32), -1.0)
    _, idx = jax.lax.top_k(scores, min(k, n))
    sel_mask = obs.mask[idx]
    if n < k:
        idx = jnp.concatenate([idx, jnp.zeros(k - n, idx.dtype)])
        sel_mask = jnp.concatenate(
            [sel_mask, jnp.zeros(k - n, sel_mask.dtype)])
    is_kf = jnp.asarray(is_kf)
    frame = jnp.asarray(frame).astype(jnp.int32)
    cap = store.xyz.shape[0]
    row = jnp.minimum(store.n, cap - 1)
    row_w = jnp.where(is_kf, row, cap)          # OOB -> dropped scatter
    frow_w = jnp.where(is_kf, jnp.clip(frame, 0, cap - 1), cap)
    return store._replace(
        xyz=store.xyz.at[row_w].set(obs.xyz[idx], mode="drop"),
        desc=store.desc.at[row_w].set(obs.desc[idx], mode="drop"),
        uv=store.uv.at[row_w].set(obs.uv_l[idx], mode="drop"),
        mask=store.mask.at[row_w].set(sel_mask, mode="drop"),
        poses=store.poses.at[row_w].set(pose, mode="drop"),
        frame_of_row=store.frame_of_row.at[row_w].set(frame, mode="drop"),
        row_of_frame=store.row_of_frame.at[frow_w].set(row, mode="drop"),
        n=store.n + is_kf.astype(jnp.int32),
    )
