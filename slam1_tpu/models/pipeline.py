"""Full SLAM driver: VO + mapping + place recognition + loop closure +
windowed local BA + pose-graph backend.

The counterpart of the reference's main.py:32-187. Per-frame
work is ONE jitted step (`slam_step`): frontend, temporal tracking, PnP,
pose chaining, keyframe policy, map insertion (per-frame observation
slots), landmark culling, BoW histogram + loop-candidate query. Only
three things live on the host:

  - the sequential frame loop (tracking is inherently serial),
  - the loop-closure TRIGGER (ref main.py:100: chi^2 < threshold):
    a data-dependent decision that would poison jit; the device returns
    a boolean every frame and the host POLLS it every
    `bow.loop_poll_every` frames (one scalar transfer — never a
    per-frame device->host sync), and
  - fixed-cadence backend launches: windowed local BA every
    `ba.local_every` keyframes, pose-graph relaxation on accepted
    loops, checkpoints every `runtime.checkpoint_every` frames.

Differences from the reference, by design:
  - BoW vocabulary trains online from a descriptor reservoir at a
    configurable frame (ref pre-trains on the whole sequence,
    main.py:43-44); pre-training frames are BACKFILLED into the DB from
    KeyframeStore descriptors so a loop returning to the sequence start
    stays findable.
  - Loop correction = proper pose-graph optimization over odometry +
    loop edges (ref smears translation linearly, loop_closure.py:48-52;
    that variant is kept as posegraph.distribute_error_linear).
  - Bundle adjustment RUNS IN THE LIVE SYSTEM (windowed Schur-LM over
    the last `ba.window` keyframes; the reference's backend is a
    separate process fed by text files, BundleAdjustment.py:186-225).
  - Checkpoint/resume via utils.checkpoint snapshots honoring
    `runtime.checkpoint_every`, not per-frame text appends
    (ref XXXport_files.py).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from slam1_tpu.config import SlamConfig
from slam1_tpu.models import bow as bow_mod
from slam1_tpu.models import mapping
from slam1_tpu.models import posegraph
from slam1_tpu.models.ba import _cost as ba_cost
from slam1_tpu.models.ba import bundle_adjust, make_problem
from slam1_tpu.models.frontend import stereo_frontend
from slam1_tpu.models.loop_closure import place_query, verify_loop_slate
from slam1_tpu.models.tracker import chain_pose, temporal_track
from slam1_tpu.ops import se3
from slam1_tpu.ops.camera import StereoCamera
from slam1_tpu.types import StereoObservations
from slam1_tpu.utils import checkpoint as ckpt_mod

MAX_LOOP_EDGES = 128
# Per-keyframe snapshot capacity (top-K features by corner score). 1024
# (not 512): loop verification matches snapshot-vs-snapshot, and a
# genuine-but-offset revisit only re-observes a fraction of them — the
# deeper snapshot roughly doubles its inlier count for one extra
# (F,512,32)-uint8 table and a bigger (but still cheap) Hamming matmul.
KF_FEATURES = 1024
PGO_BUCKETS = (512, 2048, 8192)

import time as _time


def _now() -> float:
    return _time.perf_counter()


ROW_W = 16                  # packed metrics row width
ROW_RING = 256              # device-side metrics ring capacity (frames)


class SlamState(NamedTuple):
    T_w_cam: jnp.ndarray
    prev_obs: StereoObservations
    xi_vel: jnp.ndarray
    key: jnp.ndarray
    frame: jnp.ndarray
    map: mapping.MapState
    kf: mapping.KeyframeStore
    bow: bow_mod.BowState
    traj: jnp.ndarray        # (F,4,4)
    rel: jnp.ndarray         # (F,6) twist of edge (i-1 -> i)
    rel_mask: jnp.ndarray    # (F,)
    last_kf_frame: jnp.ndarray  # () int32
    last_kf_pos: jnp.ndarray    # (3,) translation at last keyframe
    prev_lm: jnp.ndarray     # (N,) int32 landmark row of each prev_obs
                             # slot (-1 unknown) — feature-track identity
    rows: jnp.ndarray        # (ROW_RING, ROW_W) device-side metrics ring:
                             # frame f's packed row lives at f % ROW_RING.
                             # The host fetches the WHOLE ring as ONE
                             # array per drain, not N row handles


class StepOutput(NamedTuple):
    loop_hit: jnp.ndarray         # bool — trigger fired this frame
    loop_candidate: jnp.ndarray   # int32 frame index, -1 if none
    loop_chi2: jnp.ndarray        # float32
    is_kf: jnp.ndarray            # bool
    kf_n: jnp.ndarray             # int32 keyframe count after this frame
    num_stereo: jnp.ndarray
    num_inliers: jnp.ndarray
    mean_reproj_err: jnp.ndarray
    pnp_ok: jnp.ndarray
    frame: int = -1               # frame index (host bookkeeping)
    alt_cands: tuple = ()         # ((frame, chi2), ...) runner-up BoW
                                  # candidates, best-first


ALT_CAND_BASE = 10          # first runner-up (cand, chi2) pair in a row


def _unpack_row(row) -> StepOutput:
    """(ROW_W,) float32 packed metrics row -> host StepOutput.

    Layout (must mirror _step_core's out_row stack): indices 0..9 are
    the scalar metrics; ALT_CAND_BASE..ROW_W-1 hold (cand, chi2) pairs
    of runner-up loop candidates."""
    r = np.asarray(row)
    alts = tuple((int(r[k]), float(r[k + 1]))
                 for k in range(ALT_CAND_BASE, ROW_W - 1, 2) if r[k] >= 0)
    return StepOutput(
        loop_hit=bool(r[0] > 0.5), loop_candidate=int(r[1]),
        loop_chi2=float(r[2]), is_kf=bool(r[3] > 0.5), kf_n=int(r[4]),
        num_stereo=int(r[5]), num_inliers=int(r[6]),
        mean_reproj_err=float(r[7]), pnp_ok=bool(r[8] > 0.5),
        frame=int(r[9]), alt_cands=alts)


def _init_state(left, right, cam, cfg: SlamConfig, seed: int) -> SlamState:
    feats, obs = stereo_frontend(left, right, cam, cfg)
    mf = cfg.mapping.max_frames
    state = SlamState(
        T_w_cam=jnp.eye(4, dtype=left.dtype),
        prev_obs=obs,
        xi_vel=jnp.zeros(6, left.dtype),
        key=jax.random.PRNGKey(seed),
        frame=jnp.asarray(0, jnp.int32),
        map=mapping.init_map(cfg.mapping),
        kf=mapping.init_kf_store(mf, KF_FEATURES),
        bow=bow_mod.init_bow(cfg.bow, mf),
        traj=jnp.tile(jnp.eye(4, dtype=left.dtype), (mf, 1, 1)),
        rel=jnp.zeros((mf, 6), left.dtype),
        rel_mask=jnp.zeros((mf,), bool),
        last_kf_frame=jnp.asarray(0, jnp.int32),
        last_kf_pos=jnp.zeros(3, left.dtype),
        prev_lm=jnp.full((obs.mask.shape[0],), -1, jnp.int32),
        rows=jnp.zeros((ROW_RING, ROW_W), left.dtype),
    )
    # Frame 0 is always a keyframe (ref main.py:75 bootstraps frame 0).
    xyz_w = obs.xyz
    new_map, lm_of = mapping.insert(
        state.map, xyz_w, obs.desc, obs.mask, jnp.asarray(0, jnp.int32),
        obs.uv_l, cfg.mapping, uv_r_u=obs.uv_r[:, 0],
        obs_row=jnp.asarray(0, jnp.int32))
    state = state._replace(
        map=new_map,
        prev_lm=lm_of,
        kf=mapping.kf_insert(state.kf, obs, state.T_w_cam, KF_FEATURES,
                             frame=0, is_kf=True))
    k1, k2, k3 = jax.random.split(state.key, 3)
    bw = bow_mod.accumulate(state.bow, k2, feats.desc, feats.mask,
                            cfg.bow.sample_desc_per_frame)
    bw = bow_mod.add_frame(bw, k3, jnp.asarray(0, jnp.int32), feats.desc,
                           feats.mask, is_kf=True)
    state = state._replace(key=k1, bow=bw)
    return state


def _step_core(state: SlamState, left, right, cam: StereoCamera,
               cfg: SlamConfig):
    key, k_pnp, k_bow, k_bow2 = jax.random.split(state.key, 4)

    feats, obs = stereo_frontend(left, right, cam, cfg)
    track = temporal_track(k_pnp, state.prev_obs, feats, cam, cfg,
                           xi_prior=state.xi_vel)
    T_w, xi_used = chain_pose(state.T_w_cam, track.pnp, state.xi_vel)
    frame = state.frame + 1

    # Keyframe policy: every Nth frame OR enough translation since the
    # last keyframe (the lifecycle /root/reference/local_mapping.py:2-3
    # sketches; ref main.py:121 promotes every frame).
    mcfg = cfg.mapping
    dist = jnp.linalg.norm(T_w[:3, 3] - state.last_kf_pos)
    is_kf = (frame - state.last_kf_frame) >= mcfg.keyframe_every
    if mcfg.keyframe_trans > 0:
        is_kf = is_kf | (dist > mcfg.keyframe_trans)
    kf_row = state.kf.n                       # row this keyframe will take

    # Feature-track landmark identity: current slot j inherits the
    # landmark of the previous slot the tracker matched to it (inlier
    # matches only) — the co-visibility backbone of BA.
    n_slots = obs.mask.shape[0]
    inherit = (track.match_mask & track.pnp.inliers
               & (state.prev_lm >= 0))
    tgt = jnp.where(inherit, track.match_idx, n_slots)   # OOB -> dropped
    cur_lm = jnp.full((n_slots,), -1, jnp.int32).at[tgt].set(
        state.prev_lm, mode="drop")

    # Map: world-frame points of this frame's stereo observations,
    # recorded under the KEYFRAME row (windowed BA slices kf rows).
    xyz_w = se3.transform_points(T_w, obs.xyz)
    new_map, lm_of = mapping.insert(
        state.map, xyz_w, obs.desc, obs.mask & is_kf, frame, obs.uv_l,
        mcfg, uv_r_u=obs.uv_r[:, 0], obs_row=kf_row, known_row=cur_lm)
    # Carry track identity forward even through non-keyframes.
    new_prev_lm = jnp.where(lm_of >= 0, lm_of, cur_lm)

    # Landmark culling at a fixed cadence, fully on device.
    if mcfg.cull_min_obs > 0 and mcfg.cull_every > 0:
        do_cull = (frame % mcfg.cull_every) == 0
        stale = (new_map.valid & (new_map.count < mcfg.cull_min_obs)
                 & (frame - new_map.last_frame > mcfg.cull_max_age)
                 & do_cull)
        new_map = new_map._replace(valid=new_map.valid & ~stale)

    kf = mapping.kf_insert(state.kf, obs, T_w, KF_FEATURES, frame=frame,
                           is_kf=is_kf)

    # BoW: reservoir sample, histogram DB row (keyframes only), query.
    bw = bow_mod.accumulate(state.bow, k_bow, feats.desc, feats.mask,
                            cfg.bow.sample_desc_per_frame)
    bw = bow_mod.add_frame(bw, k_bow2, frame, feats.desc, feats.mask,
                           is_kf=is_kf)
    cands, chi2s = bow_mod.query_topk(bw, frame, feats.desc, feats.mask,
                                      cfg.bow, k=4)
    cand, chi2 = cands[0], chi2s[0]
    # NOTE: no `chi2 > 0` guard (ref main.py:100 has one for its raw-count
    # self-match degeneracy): an exact re-visit legitimately scores 0.
    loop_hit = (cand >= 0) & (chi2 < cfg.bow.chi2_accept)

    traj = state.traj.at[frame].set(T_w)
    rel = state.rel.at[frame].set(xi_used)
    rel_mask = state.rel_mask.at[frame].set(True)

    new_state = SlamState(
        T_w_cam=T_w, prev_obs=obs, xi_vel=xi_used, key=key, frame=frame,
        map=new_map, kf=kf, bow=bw, traj=traj, rel=rel, rel_mask=rel_mask,
        last_kf_frame=jnp.where(is_kf, frame, state.last_kf_frame),
        last_kf_pos=jnp.where(is_kf, T_w[:3, 3], state.last_kf_pos),
        prev_lm=new_prev_lm, rows=state.rows)
    # ONE packed row per frame, written into the DEVICE-SIDE ring
    # (state.rows): the host fetches the whole ring as a single array
    # per drain instead of per-frame/per-scalar device->host transfers
    # (see SlamSystem._drain_rows).
    f32 = left.dtype
    out_row = jnp.stack([
        loop_hit.astype(f32), cand.astype(f32), chi2.astype(f32),
        is_kf.astype(f32), kf.n.astype(f32),
        jnp.sum(obs.mask).astype(f32),
        track.pnp.num_inliers.astype(f32), track.pnp.mean_err,
        track.pnp.ok.astype(f32), frame.astype(f32),
        # runner-up loop candidates (NMS-separated): the host verifies
        # the top-k, not just the argmin — near the histogram noise
        # floor the argmin is often a spurious frame while the genuine
        # revisit sits in the runner-ups
        cands[1].astype(f32), chi2s[1].astype(f32),
        cands[2].astype(f32), chi2s[2].astype(f32),
        cands[3].astype(f32), chi2s[3].astype(f32)])
    new_state = new_state._replace(
        rows=state.rows.at[frame % ROW_RING].set(out_row))
    return new_state, out_row, feats


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def slam_step(state: SlamState, left, right, cam: StereoCamera,
              cfg: SlamConfig):
    """One frame per dispatched program."""
    return _step_core(state, left, right, cam, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def slam_step_block(state: SlamState, lefts, rights, cam: StereoCamera,
                    cfg: SlamConfig):
    """K frames per dispatched program (lax.scan over _step_core).

    Tracking is inherently serial, but serial does NOT mean one program
    per frame: scanning K frames inside one program pays the fixed
    per-program dispatch cost once per K frames; metrics still land
    per-frame in the state.rows ring, so the host's drain/loop-closure
    machinery is unchanged.
    """
    def body(s, lr):
        s2, row, _ = _step_core(s, lr[0], lr[1], cam, cfg)
        return s2, row
    state, rows = jax.lax.scan(body, state, (lefts, rights))
    return state, rows


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def local_ba_step(state: SlamState, cam: StereoCamera, cfg: SlamConfig,
                  end_kf=None):
    """Windowed local BA over the `ba.window` keyframes ending at
    keyframe row `end_kf` (default: the newest; BASELINE config 2 — the
    live version of ref BundleAdjustment.py:186-225).

    Builds a BAProblem from the per-keyframe observation slots, runs
    `ba.local_lm_iters` Schur-LM iterations, and feeds optimized poses
    back into the trajectory / keyframe store and optimized landmarks
    back into the map. Returns (new_state, ba_cost). `end_kf` lets the
    asynchronous backend catch up window-by-window when it consumes
    keyframe counts in bursts.
    """
    w_kf = cfg.ba.window
    kfn = state.kf.n if end_kf is None else \
        jnp.minimum(jnp.asarray(end_kf, jnp.int32), state.kf.n)
    kf_cap = state.kf.xyz.shape[0]
    start = jnp.clip(kfn - w_kf, 0, kf_cap - w_kf)
    rows = start + jnp.arange(w_kf)                         # (W,)
    row_ok = rows < kfn
    frames = state.kf.frame_of_row[rows]                    # (W,)
    fr_ok = row_ok & (frames >= 0)

    obs = state.map.obs[rows]                               # (W,OPF,4)
    ur = state.map.obs_ur[rows].reshape(-1)                 # (W*OPF,)
    opf = obs.shape[1]
    cap = state.map.xyz.shape[0]
    cam_idx = jnp.repeat(jnp.arange(w_kf, dtype=jnp.int32), opf)
    lm = obs[..., 1].astype(jnp.int32).reshape(-1)
    lm_ok = (lm >= 0) & (lm < cap)
    lmc = jnp.clip(lm, 0, cap - 1)
    slot_ok = (jnp.arange(opf)[None, :]
               < state.map.obs_count[rows][:, None]).reshape(-1)
    valid = slot_ok & lm_ok & fr_ok[cam_idx] & state.map.valid[lmc]
    uv = obs[..., 2:4].reshape(-1, 2)

    poses = state.traj[jnp.clip(frames, 0, state.traj.shape[0] - 1)]
    w = valid.astype(uv.dtype)
    wr = ((ur > 0) & valid).astype(uv.dtype)    # stereo term anchors scale

    # Compact the window's landmarks into a LOCAL table of W*OPF slots:
    # the Schur elimination then works over <=2560 landmarks instead of
    # the full map capacity (~1e5) — Hll/Jl scatters shrink ~50x.
    n_obs = lm.shape[0]
    big = jnp.asarray(cap, jnp.int32)
    ids = jnp.sort(jnp.where(valid, lm, big))                   # (O,)
    is_first = (ids < big) & jnp.concatenate(
        [jnp.ones((1,), bool), ids[1:] != ids[:-1]])
    local_of_sorted = jnp.cumsum(is_first.astype(jnp.int32)) - 1
    uniq = jnp.full((n_obs,), big, jnp.int32).at[
        jnp.where(is_first, local_of_sorted, n_obs)].set(ids, mode="drop")
    lm_local = jnp.clip(jnp.searchsorted(uniq, lm), 0, n_obs - 1)
    uniq_ok = uniq < big
    uniq_c = jnp.where(uniq_ok, uniq, 0)
    pts_local = state.map.xyz[uniq_c]

    prob = make_problem(poses, pts_local, cam_idx, lm_local, uv, w,
                        ur=ur, wr=wr)
    ba_cfg = dataclasses.replace(cfg.ba, lm_iters=cfg.ba.local_lm_iters)
    out, cost = bundle_adjust(prob, cam, ba_cfg)
    xyz_new = state.map.xyz.at[jnp.where(uniq_ok, uniq, cap)].set(
        out.points, mode="drop")

    frames_w = jnp.where(fr_ok, frames, state.traj.shape[0])
    traj = state.traj.at[frames_w].set(out.poses, mode="drop")
    rows_w = jnp.where(row_ok, rows, kf_cap)
    kf_poses = state.kf.poses.at[rows_w].set(out.poses, mode="drop")
    t_w = traj[jnp.clip(state.frame, 0, traj.shape[0] - 1)]

    # Re-derive the odometry twists of every edge touching an updated
    # pose: PGO re-solves from `rel` + loop edges, so stale twists would
    # silently revert the BA refinement at the next relaxation.
    # Convention (_pgo_step): rel[f] = -log(inv(traj[f-1]) @ traj[f]).
    lo = jnp.min(jnp.where(fr_ok, frames, jnp.iinfo(jnp.int32).max))
    hi = jnp.max(jnp.where(fr_ok, frames, -1))
    rel_new = -jax.vmap(
        lambda a, b: se3.log_se3(se3.inverse(a) @ b))(traj[:-1], traj[1:])
    f_idx = jnp.arange(1, traj.shape[0])
    # Only edges touching a pose THIS WINDOW actually changed (frames
    # [lo, hi]; edge f couples f-1 and f, hence <= hi + 1). Re-deriving
    # all the way to the current frame (the r4 bound) silently absorbed
    # every intervening pose-graph relaxation into the "odometry"
    # measurements — a feedback loop that degraded the final PGO
    # optimum at 2000-frame scale once live loop closures made mid-run
    # relaxations frequent.
    upd = (f_idx >= lo) & (f_idx <= hi + 1) & state.rel_mask[1:]
    rel = state.rel.at[1:].set(
        jnp.where(upd[:, None], rel_new, state.rel[1:]))

    new_state = state._replace(
        traj=traj,
        kf=state.kf._replace(poses=kf_poses),
        map=state.map._replace(xyz=xyz_new),
        T_w_cam=t_w,
        rel=rel)
    return new_state, cost


def build_global_problem(state: SlamState, n_kf: int,
                         obs_bucket: int = 0, loop_rows=None,
                         prior_odo_weight: float = 0.0,
                         prior_loop_weight: float = 0.0):
    """BAProblem over keyframes [0, n_kf) from the per-keyframe
    observation slots (BASELINE config 4: global BA over all keyframes).
    `n_kf` must be static (host buckets it).

    obs_bucket > 0 COMPACTS the observation axis: the raw slot layout
    is ~90% padding (n_kf * obs_per_frame slots vs the real observation
    count), and every BA linearization/CG matvec pays for all of it.
    Valid rows are sorted to the front and the first `obs_bucket`
    (static) kept — pick it as the smallest bucket >= the real count
    (host knows sum(obs_count)); overflow beyond the bucket is dropped.

    loop_rows (optional): (le_i, le_j, le_z, le_w) fixed-capacity loop
    edges in KEYFRAME-ROW indices. When given (and prior_odo_weight >
    0), the problem carries POSE-PRIOR edges: the consecutive-keyframe
    chain with the CURRENT relative poses as the prior mean ("trust the
    post-PGO increments"; residual 0 at the initial point, penalizing
    deviation of relative motion) plus the loop edges — see
    BAProblem.pe_* for why global BA needs them.
    """
    obs = state.map.obs[:n_kf]                              # (N,OPF,4)
    ur = state.map.obs_ur[:n_kf].reshape(-1)
    opf = obs.shape[1]
    cap = state.map.xyz.shape[0]
    cam_idx = jnp.repeat(jnp.arange(n_kf, dtype=jnp.int32), opf)
    lm = obs[..., 1].astype(jnp.int32).reshape(-1)
    lm_ok = (lm >= 0) & (lm < cap)
    lmc = jnp.clip(lm, 0, cap - 1)
    rows = jnp.arange(n_kf)
    row_ok = (rows < state.kf.n) & (state.kf.frame_of_row[:n_kf] >= 0)
    slot_ok = (jnp.arange(opf)[None, :]
               < state.map.obs_count[:n_kf][:, None]).reshape(-1)
    valid = slot_ok & lm_ok & row_ok[cam_idx] & state.map.valid[lmc]
    uv = obs[..., 2:4].reshape(-1, 2)
    frames = jnp.clip(state.kf.frame_of_row[:n_kf], 0,
                      state.traj.shape[0] - 1)
    poses = state.traj[frames]
    w = valid.astype(uv.dtype)
    wr = ((ur > 0) & valid).astype(uv.dtype)
    if obs_bucket and obs_bucket < lm.shape[0]:
        order = jnp.argsort(~valid, stable=True)[:obs_bucket]
        cam_idx = cam_idx[order]
        lmc = lmc[order]
        uv = uv[order]
        w = w[order]
        ur = ur[order]
        wr = wr[order]
    pe = {}
    if loop_rows is not None and prior_odo_weight > 0:
        le_i, le_j, le_z, le_w = loop_rows
        ei = jnp.arange(n_kf - 1, dtype=jnp.int32)
        chain_ok = row_ok[:-1] & row_ok[1:]
        z_chain = jax.vmap(
            lambda a, b: se3.inverse(a) @ b)(poses[:-1], poses[1:])
        pe = dict(
            pe_i=jnp.concatenate([ei, le_i.astype(jnp.int32)]),
            pe_j=jnp.concatenate([ei + 1, le_j.astype(jnp.int32)]),
            pe_z=jnp.concatenate([z_chain, le_z]),
            pe_w=jnp.concatenate([
                prior_odo_weight * chain_ok.astype(uv.dtype),
                prior_loop_weight * (le_w > 0).astype(uv.dtype)]))
    return make_problem(poses, state.map.xyz, cam_idx, lmc, uv, w,
                        ur=ur, wr=wr, **pe), frames


@functools.partial(jax.jit,
                   static_argnames=("cfg", "n_kf", "obs_bucket",
                                    "return_trace"))
def global_ba_step(state: SlamState, cam: StereoCamera, cfg: SlamConfig,
                   n_kf: int, obs_bucket: int = 0,
                   return_trace: bool = False, loop_rows=None):
    """Global BA over the first n_kf keyframes; returns updated state.
    `obs_bucket`: static compacted observation count (see
    build_global_problem) — callers pick the smallest bucket covering
    int(sum(map.obs_count[:n_kf])). `return_trace` additionally returns
    the per-LM-iteration BATrace (convergence diagnostics). `loop_rows`
    (fixed-capacity keyframe-row loop edges) enables the pose-prior
    regularization — see build_global_problem."""
    prob, frames = build_global_problem(
        state, n_kf, obs_bucket, loop_rows=loop_rows,
        prior_odo_weight=(cfg.ba.prior_odo_weight
                          if loop_rows is not None else 0.0),
        prior_loop_weight=cfg.ba.prior_loop_weight)
    if cfg.ba.global_trim_px > 0:
        # One-shot association gate at the (post-PGO) initial point:
        # the observation store accumulates a small garbage tail —
        # mis-inherited landmark identities, voxel-merge gluings, and
        # points driven to the z>=1e-3 clamp whose residuals reach 1e6+
        # px. Measured at both 600- and 2000-frame scale: the top 10%
        # of residuals carry 99% of the reprojection cost (median
        # residual 3.4 px) and every LM step chases them — one
        # overshooting accept, then rejections to lam ~ 3e4 and an ATE
        # *regression*. Trimming at a fixed pixel radius before the
        # solve (not a graduated in-loop cut: the trajectory is
        # already globally consistent here) removes the junk while
        # keeping >95% of real observations.
        _, r0, _ = ba_cost(prob, cam, cfg.ba.huber_delta)
        rn0 = jnp.linalg.norm(r0[:, :2], axis=-1)
        keep = (rn0 < cfg.ba.global_trim_px).astype(prob.w.dtype)
        prob = prob._replace(w=prob.w * keep, wr=prob.wr * keep)
    trace = None
    if return_trace:
        out, cost, trace = bundle_adjust(prob, cam, cfg.ba,
                                         return_trace=True)
    else:
        out, cost = bundle_adjust(prob, cam, cfg.ba)
    # Row-validity discipline: only REAL keyframe rows write back
    # (n_kf is a bucket >= kf.n; padding rows' frames clip to 0 and
    # would otherwise scatter onto traj[0]).
    rows = jnp.arange(n_kf)
    ok = (rows < state.kf.n) & (state.kf.frame_of_row[:n_kf] >= 0)
    frames_w = jnp.where(ok, frames, state.traj.shape[0])
    traj = state.traj.at[frames_w].set(out.poses, mode="drop")
    rows_w = jnp.where(ok, rows, state.kf.poses.shape[0])
    kf_poses = state.kf.poses.at[rows_w].set(out.poses, mode="drop")
    t_w = traj[jnp.clip(state.frame, 0, traj.shape[0] - 1)]
    new_state = state._replace(
        traj=traj, kf=state.kf._replace(poses=kf_poses),
        map=state.map._replace(xyz=out.points), T_w_cam=t_w)
    if return_trace:
        return new_state, cost, trace
    return new_state, cost


@functools.partial(jax.jit, static_argnames=("bucket", "iters", "cg_iters"))
def _pgo_step(traj, rel, rel_mask, kf_frames, kf_mask, le_i, le_j, le_z,
              le_w, frame, map_xyz, map_last, map_valid,
              bucket: int, iters: int, cg_iters: int):
    """Pose-graph relaxation over the first `bucket` poses (static),
    plus LANDMARK RE-ANCHORING: each map point rides the pose
    correction of its anchor frame (last observation). Without this,
    a loop closure moves the trajectory while the map stays in the
    drifted frame — every subsequent local/global BA then starts from
    hundreds-of-px residuals and its outlier cut zeroes the very
    observations that could pull things together (observed at config-4
    scale: global BA left keyframe ATE unchanged)."""
    traj_old = traj
    t = traj[:bucket]
    ei = jnp.arange(bucket - 1, dtype=jnp.int32)
    # rel[f] = log(T_f_{f-1}) (tracker convention: X_cur = T @ X_prev);
    # the pose-graph edge measurement is T_{f-1}_f = exp(-rel[f]).
    z_odo = se3.exp_se3(-rel[1:bucket])
    w_odo = rel_mask[1:bucket].astype(jnp.float32)
    graph = posegraph.PoseGraph(
        poses=t,
        ei=jnp.concatenate([ei, le_i]),
        ej=jnp.concatenate([ei + 1, le_j]),
        z=jnp.concatenate([z_odo, le_z]),
        w=jnp.concatenate([w_odo, le_w]))
    opt, cost = posegraph.optimize(graph, iters=iters, cg_iters=cg_iters)
    # Last-line defence: never let a non-finite relaxation replace a
    # finite trajectory (poisoning every downstream consumer).
    opt = jnp.where(jnp.isfinite(opt).all(), opt, t)
    traj = traj.at[:bucket].set(opt)
    t_w = traj[jnp.clip(frame, 0, traj.shape[0] - 1)]
    # Refresh keyframe poses from the relaxed trajectory.
    new_kf_poses = traj[jnp.clip(kf_frames, 0, traj.shape[0] - 1)]
    # Re-anchor landmarks: X' = T_new[f] @ inv(T_old[f]) @ X with f the
    # landmark's last-observation frame (cheap rigid approximation; BA
    # refines from there).
    f_lm = jnp.clip(map_last, 0, traj.shape[0] - 1)
    d = traj[f_lm] @ se3.inverse(traj_old[f_lm])          # (CAP,4,4)
    xyz2 = (d[:, :3, :3] @ map_xyz[..., None])[..., 0] + d[:, :3, 3]
    xyz2 = jnp.where(map_valid[:, None], xyz2, map_xyz)
    return traj, t_w, new_kf_poses, kf_mask, xyz2, cost


@jax.jit
def _pack_slate_result(res) -> jnp.ndarray:
    """Batched LoopPairResult (leading (K,) axis) -> one (K,19) array
    [T.flat, anchor, inliers, ok] per row, so the host fetches a whole
    verification slate with ONE transfer."""
    f32 = res.T_anchor_cand.dtype
    k = res.ok.shape[0]
    return jnp.concatenate([
        res.T_anchor_cand.reshape(k, 16),
        jnp.stack([res.anchor_frame.astype(f32),
                   res.num_inliers.astype(f32),
                   res.ok.astype(f32)], axis=-1)], axis=-1)


@dataclasses.dataclass
class LoopEvent:
    frame: int
    candidate: int
    chi2: float
    num_inliers: int
    accepted: bool


class SlamSystem:
    """Host-side orchestrator (the `slam.run(config)` API, SURVEY C24).

    Host-device discipline: NOTHING in the per-frame path forces a
    host<->device synchronization (not even copy_to_host_async). Each
    slam_step emits one packed metrics row; a worker thread device_gets
    BATCHES of rows (age-gated by `bow.poll_lag_s`), with a small forced
    drain every `bow.poll_max_pending` frames as the latency bound. The
    backend (loop detection, local BA, PGO) therefore runs as an
    asynchronous consumer lagging the camera loop by at most that many
    frames, never stalling it per-frame — the counterpart of the
    reference's separate backend process (BundleAdjustment.py:186-225).
    """

    def __init__(self, cam: StereoCamera, cfg: Optional[SlamConfig] = None,
                 seed: int = 0, bow_train_frame: int = 30):
        self.cam = cam
        self.cfg = cfg or SlamConfig()
        self.seed = seed
        self.bow_train_frame = bow_train_frame
        self.state: Optional[SlamState] = None
        self.loop_edges: list = []       # (i, j, Z (4,4) np, weight)
        self.loop_events: list = []
        self.metrics: list = []          # host-side StepOutputs (drained)
        self.ba_costs: list = []
        self.frame_count = 0             # host mirror of state.frame
        self._rearm_at = 0
        self._kf_at_last_ba = 1
        self._bow_trained = False
        self._hit_history = []           # rolling [(frame, [(cand, chi2)])]
                                         # of recent BoW hit rows
        self._last_drained = 0           # newest frame whose metrics row
                                         # has been fetched from the ring
        self._verifying: list = []       # (t, rows, packed, depth) slates
        self._last_place_kf = 0          # newest kf row already place-queried
        # Transport discipline: every device->host read waits for the
        # device, so the camera loop reads back exactly ONE array (the
        # state.rows metrics ring) per `bow.poll_max_pending` frames,
        # from a fetch thread; that bound is the backend
        # latency contract (loop detection/verification/PGO lag the
        # camera by at most that many frames — within
        # verify_loop_pair's lag tolerance by design). poll_lag_s > 0
        # selects this batched-drain mode; 0 = drain at every poll
        # (synchronous, deterministic — the tests' configuration).
        self._async = getattr(self.cfg.bow, "poll_lag_s", 0.0) > 0.0
        self._pool = None
        self._verify_inflight = None     # Future for one verification get
        if self._async:
            import concurrent.futures
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="slam-fetch")

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)

    # ------------------------------------------------------------- core
    def process(self, left, right):
        cfg = self.cfg
        if self.state is None:
            self.state = _init_state(left, right, self.cam, cfg, self.seed)
            self.frame_count = 0
            return None

        if (self.frame_count - self._last_drained) + 1 > ROW_RING:
            self._poll(force=True)       # never let the ring wrap
        self.state, out_row, _ = slam_step(self.state, left, right,
                                           self.cam, cfg)
        # NOTE: deliberately NO per-frame copy_to_host_async / handle
        # retention: the metrics live in the device-side ring
        # (state.rows); _drain_rows fetches it as ONE array.
        self._after_frames(1)
        return out_row

    def process_block(self, lefts, rights):
        """Process a (K,H,W) block of frames with ONE dispatched program
        (slam_step_block), paying the per-program dispatch cost once
        per K frames. Bootstrap frame 0 with process() first. Host-side
        cadences (BoW training, polls, checkpoints) land on block
        boundaries."""
        assert self.state is not None, "bootstrap with process() first"
        k = int(lefts.shape[0])
        assert k <= ROW_RING, (
            f"block of {k} frames exceeds the {ROW_RING}-row metrics "
            f"ring; split the block")
        # Never let the ring wrap: rows carry loop-closure trigger bits,
        # so overflow loses closures, not just telemetry. Drain BEFORE
        # dispatching the block that would overwrite undrained rows.
        if (self.frame_count - self._last_drained) + k > ROW_RING:
            self._poll(force=True)
        self.state, _ = slam_step_block(self.state, lefts, rights,
                                        self.cam, self.cfg)
        self._after_frames(k)

    def _crossed(self, every: int, k: int) -> bool:
        return every > 0 and (self.frame_count // every
                              != (self.frame_count - k) // every)

    def _after_frames(self, k: int):
        cfg = self.cfg
        self.frame_count += k
        frame = self.frame_count
        if (not self._bow_trained) and frame >= self.bow_train_frame:
            self._train_bow()
            self._bow_trained = True
        if self._crossed(cfg.bow.loop_poll_every, k):
            self._poll()
        # Checkpoint AFTER the poll so backend work launched this frame
        # (local BA, PGO) is captured — resume then replays identically.
        rt = cfg.runtime
        if self._crossed(rt.checkpoint_every, k):
            self.save_checkpoint(os.path.join(
                rt.checkpoint_dir, f"ckpt_{frame:06d}.npz"))

    def _drain_rows(self, force):
        """Fetch undrained metrics rows from the device ring as ONE
        array transfer. In async mode the fetch happens only when
        `poll_max_pending` frames have accumulated (or on force) — the
        single bounded pipeline bubble per window; in sync mode (tests)
        at every poll. Returns raw (ROW_W,) numpy rows, oldest first."""
        n_new = self.frame_count - self._last_drained
        if n_new <= 0:
            return []
        if self._async and not force \
                and n_new < self.cfg.bow.poll_max_pending:
            return []
        ring = np.asarray(jax.device_get(self.state.rows))
        start = self._last_drained + 1
        if n_new > ROW_RING:
            # Drains were disabled longer than the ring: the oldest
            # rows were overwritten. Keep the newest ROW_RING.
            import warnings
            warnings.warn(f"metrics ring overflowed: "
                          f"{n_new - ROW_RING} rows lost")
            start = self.frame_count - ROW_RING + 1
        rows = [ring[f % ROW_RING] for f in
                range(start, self.frame_count + 1)]
        self._last_drained = self.frame_count
        return rows

    def _poll(self, force=False):
        """Consume landed metrics rows; launch backend work if due.

        force=True (finalize/checkpoint) drains everything, blocking on
        reads still in flight.
        """
        cfg = self.cfg
        self._consume_verifications(force)
        rows = self._drain_rows(force)
        if not rows:
            return
        drained = [r if isinstance(r, StepOutput) else _unpack_row(r)
                   for r in rows]
        self.metrics.extend(drained)
        latest = drained[-1]
        kf_n = int(latest.kf_n)

        # Brute-force place recognition (the production retrieval
        # path; loop_closure.place_query): once per drain, match the
        # newest keyframe's snapshot against every stored snapshot and
        # hand the top candidates straight to slate verification. The
        # per-frame BoW trigger machinery below stays as telemetry and
        # as the retrieval for configs where the exhaustive product
        # isn't worth its FLOPs (cfg.bow.place_query=False).
        if (cfg.bow.place_query and kf_n > self._last_place_kf
                and kf_n >= 2):
            self._last_place_kf = kf_n
            q_row = kf_n - 1
            q_frame = int(np.asarray(
                self.state.kf.frame_of_row[q_row]))
            max_frame = q_frame - cfg.bow.query_exclude
            if max_frame > 0:
                cap = self.state.kf.desc.shape[0]
                n_rows = next((b for b in (128, 512, 1024, 2048, 8192)
                               if b >= kf_n and b <= cap), cap)
                cands, scores = place_query(
                    self.state.kf, q_row, max_frame, n_rows,
                    k=cfg.bow.place_topk,
                    thresh=cfg.bow.place_thresh,
                    nms_frames=cfg.bow.place_nms_frames)
                cands = np.asarray(cands)
                scores = np.asarray(scores)
                pairs = [(q_frame, int(c), float(s))
                         for c, s in zip(cands, scores) if c >= 0]
                if pairs:
                    self._try_close_loop(pairs)

        # Collect ALL drained hit rows (a hit on a non-poll frame that
        # fades by the poll frame must not be dropped) into a rolling
        # history; verification runs keyframe-vs-keyframe
        # (verify_loop_pair) so consumption lag cannot invalidate it.
        gate = cfg.bow.chi2_accept * self.ALT_CHI2_SLACK
        nf = self.frame_count - len(drained) + 1  # fallback numbering
        newest = None
        for k, r in enumerate(drained):
            if not bool(r.loop_hit):
                continue
            hf = int(r.frame)
            if hf < 0:
                hf = max(nf + k, 0)
            cands = [(int(r.loop_candidate), float(r.loop_chi2))] + [
                (c, v) for c, v in r.alt_cands if c >= 0 and v <= gate]
            self._hit_history.append((hf, cands))
            newest = (hf, cands)
        del self._hit_history[:-self.HIT_HISTORY]
        # NOTE: no global post-closure re-arm gate here — per-window
        # suppression lives in _try_close_loop (_edge_is_dup covers a
        # CLOSED window forever; in-flight suppression covers a window
        # under verification), so a different genuine revisit right
        # after a closure is still dispatched.
        if self._bow_trained and newest:
            # Progression-consistent confirmation: a genuine revisit's
            # BoW candidate ADVANCES with the camera — between two hit
            # rows `gap` frames apart, candidate indices must differ by
            # ~gap (either direction, +-candidate_tol). Requiring the
            # SAME candidate index across polls would reject every
            # moving revisit; requiring nothing lets a single spurious
            # hit fire a 1000x-weight loop edge. Support is counted
            # over the whole rolling history (drains arrive in bursts
            # through the async fetcher, so "consecutive polls" is not
            # a usable clock — row-level history is).
            hf, cur = newest
            tol = cfg.bow.candidate_tol
            need = max(cfg.bow.confirm_polls - 1, 1)
            confirmed = []
            for c, v in cur:
                support = 0
                for phf, pcands in self._hit_history:
                    gap = hf - phf
                    if gap <= 0 or gap > self.HIT_WINDOW:
                        continue
                    if any(min(abs(c - p - gap), abs(c - p + gap)) <= tol
                           for p, _ in pcands):
                        support += 1
                if support >= need:
                    confirmed.append((c, v))
            strong = cur[0][1] <= cfg.bow.chi2_strong
            if confirmed or strong:
                # verify every confirmed candidate (NMS keeps them
                # spatially distinct): near the noise floor the argmin
                # is often a spurious frame while the genuine revisit
                # sits in the runner-ups — geometric verification is
                # the arbiter, so give it the full slate. A STRONG
                # argmin always rides along even when progression noise
                # "confirmed" other candidates — dropping a near-exact
                # revisit in favour of confirmed noise cost the
                # endpoint closure on the bench clip.
                confirmed.sort(key=lambda cv: cv[1])
                slate = list(confirmed) if confirmed else list(cur)
                if strong and all(c != cur[0][0] for c, _ in slate):
                    slate.insert(0, cur[0])
                pairs = [(hf, c, v) for c, v in slate]
                # SECOND anchor: the newest hit row is one BoW sample;
                # a hit row ~half a drain window older gives an
                # independent slate against an older anchor keyframe —
                # when the newest slate is all noise, the second anchor
                # still lands the genuine pair (drains are the scarce
                # resource, slates are cheap).
                for phf, pcands in reversed(self._hit_history[:-1]):
                    if hf - phf >= self.SECOND_ANCHOR_GAP:
                        pairs += [(phf, c, v) for c, v in pcands[:2]]
                        break
                self._try_close_loop(pairs)

        # Launch one windowed BA per missed cadence window: bursty row
        # consumption (the fetcher drains in batches) must not skip
        # windows, or drift correction degrades with fetch latency.
        if cfg.ba.local_every:
            while kf_n - self._kf_at_last_ba >= cfg.ba.local_every:
                self._kf_at_last_ba += cfg.ba.local_every
                self.state, cost = local_ba_step(
                    self.state, self.cam, cfg,
                    end_kf=jnp.asarray(self._kf_at_last_ba, jnp.int32))
                self.ba_costs.append(cost)  # device scalar; pulled lazily

    def _train_bow(self):
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed), 999)
        self.state = self.state._replace(
            bow=bow_mod.train(self.state.bow, key, self.cfg.bow))
        # Backfill DB rows for keyframes seen before the vocab existed
        # (ref trains on the full sequence so every frame is queryable,
        # main.py:43-44; see bow.backfill_chunk).
        chunk = 128
        for s in range(0, self.frame_count + 1, chunk):
            self.state = self.state._replace(bow=bow_mod.backfill_chunk(
                self.state.bow, s, chunk))

    # ----------------------------------------------------- loop closure
    # Runner-up candidates are only worth a geometric check while their
    # histogram distance is in the same league as the accept gate.
    ALT_CHI2_SLACK = 1.5
    MAX_VERIFY_PER_HIT = 6
    HIT_HISTORY = 24                 # hit rows kept for confirmation
    HIT_WINDOW = 32                  # max frame gap that counts as support
    SECOND_ANCHOR_GAP = 16           # min age of the second verify anchor

    def _try_close_loop(self, pairs):
        """Dispatch candidate-vs-anchor keyframe verifications (device
        work, no sync); results are consumed asynchronously at a later
        poll (_consume_verifications). BoW proposals are cheap and
        noisy — geometric verification is the precision gate — so
        attempts must not stall the camera loop either.

        `pairs` is a list of (hit_frame, candidate_frame, chi2), best
        first; each distinct candidate (beyond candidate_tol of one
        already dispatched) gets its own verification against its own
        hit-frame anchor — the argmin of a noisy histogram scan is
        routinely a few frames off the best verifiable revisit, and a
        rejected argmin must not cost the whole closure. Acceptance
        stays exclusive: the first verified edge re-arms the window and
        _apply_slate drops the rest."""
        tol = self.cfg.bow.candidate_tol
        # Per-candidate-window suppression (NOT a blanket history clear):
        # a candidate is skipped only while a verification for the same
        # physical revisit is STILL IN FLIGHT — same candidate window,
        # or the progression-advanced image of one (a revisit's BoW
        # candidate advances with the camera, so the "same" revisit
        # re-surfaces at c' ~ c + gap a drain later). Once the earlier
        # verification is consumed the window re-opens: a later hit
        # pairs the candidate with a DIFFERENT (newer) anchor keyframe,
        # which is a genuinely new geometric test, and unrelated
        # revisits in the next drain keep their support evidence either
        # way. (r4's blanket `_hit_history = []` back-off cost recall at
        # 2000-frame scale; a time-windowed suppression of the candidate
        # region cost the genuine end-of-lap closure on the 36-frame
        # test clip — in-flight-keyed suppression does neither.)
        inflight = [(phf, pc) for _t, rows, _p, _d in self._verifying
                    for phf, pc, _v in rows]
        if self._verify_inflight is not None:
            _fut, vrows, _d = self._verify_inflight
            inflight += [(vf, vc) for vf, vc, _v in vrows]

        def _suppressed(hf, c):
            if self._edge_is_dup(c, hf):
                return True              # window already closed: an edge
                                         # within EDGE_DEDUP_W exists
            for phf, pc in inflight:
                gap = hf - phf
                if gap < 0:
                    continue
                if min(abs(c - pc), abs(c - pc - gap),
                       abs(c - pc + gap)) <= tol:
                    return True
            return False

        todo = []
        for hf, c, v in pairs:
            if len(todo) >= self.MAX_VERIFY_PER_HIT:
                break
            if (c >= 0 and all(abs(c - c2) > tol for _, c2, _v in todo)
                    and not _suppressed(hf, c)):
                todo.append((hf, c, v))
        if todo:
            self._dispatch_slate(todo, depth=0)
        # The hit history is kept — clearing it wholesale (the r4
        # design) also discarded the support evidence of a DIFFERENT
        # genuine revisit arriving in the next drain, costing recall at
        # 2000-frame scale where multiple revisit windows are
        # concurrently open.

    SLATE_K = 8                          # static slate width (padded)

    def _dispatch_slate(self, rows, depth=0, salt=0):
        """Dispatch a whole slate of candidate-vs-anchor verifications
        as ONE vmapped program (verify_loop_slate) producing ONE packed
        (K,19) result array; the async consumer fetches it later with a
        single transfer, instead of one program and one fetch per pair.
        `rows` is
        [(hit_frame, cand_frame, chi2)]; padded to the static SLATE_K
        with cand=-1 (ok=False rows)."""
        rows = rows[:self.SLATE_K]
        pad = self.SLATE_K - len(rows)
        hfs = [hf for hf, _c, _v in rows] + [0] * pad
        cs = [c for _hf, c, _v in rows] + [-1] * pad
        base = jax.random.PRNGKey(self.seed ^ 0x5a5a)
        keys = jnp.stack([
            jax.random.fold_in(base,
                               (hf * 7919 + c * 31 + salt) & 0x7fffffff)
            for hf, c in zip(hfs, cs)])
        res = verify_loop_slate(keys, self.state.kf,
                                jnp.asarray(cs, jnp.int32),
                                jnp.asarray(hfs, jnp.int32),
                                self.cam, self.cfg)
        self._verifying.append((_now(), rows, _pack_slate_result(res),
                                depth))

    def _retry_rows(self, frame, cand, chi2, a_frame):
        """Retry slate for a near-miss: a near-miss verification
        (inliers just under the accept gate) is usually a genuine
        revisit seen through a slightly-off (candidate, anchor)
        pairing — the BoW argmin is routinely a keyframe or two off the
        best-overlapping frame, and the 1024-hypothesis RANSAC itself
        flips on the PRNG key for marginal pairs. Retry the adjacent
        candidate keyframes against the same anchor, the same candidate
        against the PRECEDING anchor keyframe, and the original pair
        under a fresh key. Observed at 2000-frame scale: genuine
        revisits die at 6-14 inliers vs min_loop_inliers=15 while
        spurious candidates sit at 2-4 — the retry band recovers the
        former without admitting the latter."""
        ke = max(self.cfg.mapping.keyframe_every, 1)
        rows = [(frame, cand, chi2),          # fresh key (salt differs)
                (frame, cand - ke, chi2),
                (frame, cand + ke, chi2)]
        if a_frame > 0:
            rows.append((a_frame - 1, cand, chi2))
        return [(hf, c, v) for hf, c, v in rows if c >= 0]

    NEAR_MISS_MIN = 7

    def _edge_is_dup(self, cand, anchor) -> bool:
        """An accepted edge suppresses further edges of the SAME revisit
        window (BOTH endpoints within bow.rearm_frames) — NOT a global
        re-arm: r5 try2 verified 6 genuine closures across 4 distinct
        windows but the global rearm (ref main.py:106) kept only 3
        edges, throwing away exactly the distinct-window constraints
        PGO needs most at 2000-frame scale."""
        wnd = max(self.cfg.bow.rearm_frames, 1)
        return any(abs(cand - i) <= wnd and abs(anchor - j) <= wnd
                   for i, j, _Z, _w in self.loop_edges)

    def _apply_slate(self, rows, fetched, depth=0):
        """Consume one fetched (K,19) slate: record events, accept
        verified edges of DISTINCT revisit windows (per-window dedup,
        see EDGE_DEDUP_W), and collect ONE depth-1 retry slate from
        near-miss rows."""
        packed = np.asarray(fetched)
        retries = []
        for k, (frame, cand, chi2) in enumerate(rows):
            row = packed[k]
            T_ac = row[:16].reshape(4, 4)
            a_frame = int(row[16])
            n_inl = int(row[17])
            ok = bool(row[18] > 0.5)
            self.loop_events.append(LoopEvent(
                frame=frame, candidate=cand, chi2=chi2,
                num_inliers=n_inl, accepted=ok))
            if not ok:
                if (depth == 0 and n_inl >= self.NEAR_MISS_MIN
                        and not self._edge_is_dup(cand, frame)):
                    retries += self._retry_rows(frame, cand, chi2,
                                                a_frame)
                continue
            if self._edge_is_dup(cand, a_frame):
                continue              # this revisit window already closed
            if not np.isfinite(T_ac).all():
                continue              # degenerate RANSAC output
            # Edge (cand, anchor): Z = T_cand_anchor = inv(T_anchor_cand)
            Z = np.asarray(np.linalg.inv(np.asarray(T_ac)))
            self.loop_edges.append((cand, a_frame, Z,
                                    float(self.cfg.ba.pg_loop_weight)))
            self._rearm_at = frame + self.cfg.bow.rearm_frames
            # Immediate trajectory relaxation over the affected span
            # (deferred to one batch relaxation during the offline
            # sweep, detect_loops_offline).
            if not getattr(self, "_defer_pgo", False):
                self._run_pgo()
        if retries:
            # Dedupe within the retry slate (distinct windows only).
            seen = []
            uniq = []
            for hf, c, v in retries:
                if all((hf, c) != s for s in seen):
                    seen.append((hf, c))
                    uniq.append((hf, c, v))
            self._dispatch_slate(uniq, depth=1, salt=1)

    def _consume_verifications(self, force=False):
        if not self._async:
            # Retries dispatched by _apply_slate extend _verifying
            # mid-iteration — drain until empty.
            while self._verifying:
                pending, self._verifying = self._verifying, []
                for _, rows, packed, depth in pending:
                    self._apply_slate(rows, jax.device_get(packed),
                                      depth=depth)
            return
        while True:
            vi = self._verify_inflight
            if vi is not None:
                fut, rows, depth = vi
                if not (force or fut.done()):
                    return
                self._verify_inflight = None
                self._apply_slate(rows, fut.result(), depth=depth)
            if not self._verifying:
                return
            _, rows, packed, depth = self._verifying.pop(0)
            fut = self._pool.submit(jax.device_get, packed)
            self._verify_inflight = (fut, rows, depth)
            if not force:
                return

    def loop_edge_rows(self, cap: int = MAX_LOOP_EDGES):
        """Fixed-capacity (le_i, le_j, le_z, le_w) loop edges with
        endpoints converted to KEYFRAME-ROW indices — the pose-prior
        input of global_ba_step (camera rows of the global problem are
        keyframe rows, while loop_edges store frame indices)."""
        rof = np.asarray(self.state.kf.row_of_frame)
        le_i = np.zeros(cap, np.int32)
        le_j = np.zeros(cap, np.int32)
        le_z = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
        le_w = np.zeros(cap, np.float32)
        k = 0
        for i, j, Z, w in self.loop_edges[-cap:]:
            ri = int(rof[i]) if 0 <= i < rof.shape[0] else -1
            rj = int(rof[j]) if 0 <= j < rof.shape[0] else -1
            if ri < 0 or rj < 0:
                continue
            le_i[k], le_j[k], le_z[k], le_w[k] = ri, rj, Z, w
            k += 1
        return (jnp.asarray(le_i), jnp.asarray(le_j),
                jnp.asarray(le_z), jnp.asarray(le_w))

    def detect_loops_offline(self, stride_kf: int = 8,
                             run_pgo: bool = True) -> int:
        """Post-hoc loop-closure sweep over the whole keyframe store
        (the map-revisit analogue of ORB-SLAM's loop detection on a
        built map; the reference has no counterpart — its loop scan
        only ever runs frame-by-frame during the live pass,
        main.py:99-118).

        Every `stride_kf`-th keyframe is place-queried against the full
        store (loop_closure.place_query) and its top candidates go
        through the standard slate verification; accepted edges use the
        same per-window dedup as the live path, so already-closed
        windows cost one query and no verification. Per-accept PGO is
        DEFERRED to one full-strength relaxation at the end. Returns
        the number of loop edges added."""
        cfg = self.cfg
        kf_n = int(np.asarray(self.state.kf.n))
        if kf_n < 2:
            return 0
        cap = self.state.kf.desc.shape[0]
        n_rows = next((b for b in (128, 512, 1024, 2048, 8192)
                       if b >= kf_n and b <= cap), cap)
        fo = np.asarray(self.state.kf.frame_of_row[:kf_n])
        n0 = len(self.loop_edges)
        self._defer_pgo = True
        try:
            for q_row in range(stride_kf, kf_n, stride_kf):
                q_frame = int(fo[q_row])
                max_frame = q_frame - cfg.bow.query_exclude
                if max_frame <= 0:
                    continue
                cands, scores = place_query(
                    self.state.kf, q_row, max_frame, n_rows,
                    k=cfg.bow.place_topk, thresh=cfg.bow.place_thresh,
                    nms_frames=cfg.bow.place_nms_frames)
                pairs = [(q_frame, int(c), float(s))
                         for c, s in zip(np.asarray(cands),
                                         np.asarray(scores)) if c >= 0]
                if pairs:
                    self._try_close_loop(pairs)
                self._consume_verifications(force=True)
        finally:
            self._defer_pgo = False
        added = len(self.loop_edges) - n0
        if run_pgo and added:
            self._run_pgo(iters=self.cfg.ba.pg_iters)
        return added

    def _run_pgo(self, iters: Optional[int] = None):
        st = self.state
        n = self.frame_count + 1
        f_cap = st.traj.shape[0]
        bucket = next((b for b in PGO_BUCKETS if b >= n and b <= f_cap),
                      f_cap)

        le_i = np.zeros(MAX_LOOP_EDGES, np.int32)
        le_j = np.zeros(MAX_LOOP_EDGES, np.int32)
        le_z = np.tile(np.eye(4, dtype=np.float32), (MAX_LOOP_EDGES, 1, 1))
        le_w = np.zeros(MAX_LOOP_EDGES, np.float32)
        edges = self.loop_edges
        if len(edges) > MAX_LOOP_EDGES:
            # Keep the most RECENT edges (older corrections are partly
            # baked into traj by previous relaxations) and say so —
            # never drop constraints silently.
            import warnings
            warnings.warn(
                f"pose graph holds {len(edges)} loop edges; only the "
                f"newest {MAX_LOOP_EDGES} are used (MAX_LOOP_EDGES)")
            edges = edges[-MAX_LOOP_EDGES:]
        for k, (i, j, Z, w) in enumerate(edges):
            le_i[k], le_j[k], le_z[k], le_w[k] = i, j, Z, w

        traj, t_w, kf_poses, kf_mask, map_xyz, cost = _pgo_step(
            st.traj, st.rel, st.rel_mask, st.kf.frame_of_row,
            st.kf.frame_of_row >= 0, jnp.asarray(le_i), jnp.asarray(le_j),
            jnp.asarray(le_z), jnp.asarray(le_w), st.frame,
            st.map.xyz, st.map.last_frame, st.map.valid,
            bucket=bucket,
            iters=(iters or max(self.cfg.ba.pg_iters // 5, 3)),
            cg_iters=self.cfg.ba.cg_iters)
        kf_sel = jnp.where(kf_mask[:, None, None], kf_poses, st.kf.poses)
        self.state = st._replace(traj=traj, T_w_cam=t_w,
                                 kf=st.kf._replace(poses=kf_sel),
                                 map=st.map._replace(xyz=map_xyz))

    # ------------------------------------------------ checkpoint/resume
    def save_checkpoint(self, path: str):
        # Drain pending rows first: resume replays from the snapshot, so
        # unconsumed trigger rows would otherwise be lost. A hit among
        # the drained rows dispatches a NEW verification into
        # _verifying, so consume verifications AGAIN after the poll —
        # otherwise that loop edge exists in the live run but not in the
        # snapshot (the trigger rows were already consumed), breaking
        # resume equivalence.
        self._poll(force=True)
        self._consume_verifications(force=True)
        meta = {
            "frame_count": self.frame_count,
            "rearm_at": self._rearm_at,
            "kf_at_last_ba": self._kf_at_last_ba,
            "seed": self.seed,
            "bow_train_frame": self.bow_train_frame,
            "bow_trained": self._bow_trained,
            "hit_history": self._hit_history,
            "last_place_kf": self._last_place_kf,
            "loop_edges": [
                (int(i), int(j), np.asarray(Z).tolist(), float(w))
                for i, j, Z, w in self.loop_edges],
        }
        ckpt_mod.save(path, self.state, meta=meta)

    @classmethod
    def resume(cls, path: str, cam: StereoCamera,
               cfg: Optional[SlamConfig] = None) -> "SlamSystem":
        """Restore a system from a checkpoint (the counterpart of the
        reference backend restarting from ourCache/,
        BundleAdjustment.py:12-17)."""
        cfg = cfg or SlamConfig()
        meta = ckpt_mod.load_meta(path)
        sys_ = cls(cam, cfg, seed=meta["seed"],
                   bow_train_frame=meta["bow_train_frame"])
        # Template state for the pytree structure.
        template = _template_state(cam, cfg, meta["seed"])
        sys_.state = ckpt_mod.load(path, template)
        sys_.frame_count = meta["frame_count"]
        sys_._last_drained = meta["frame_count"]   # ring rows were
        # consumed by the pre-checkpoint force-drain
        sys_._rearm_at = meta["rearm_at"]
        sys_._kf_at_last_ba = meta["kf_at_last_ba"]
        sys_._bow_trained = meta.get("bow_trained", False)
        sys_._hit_history = [
            (int(hf), [(int(c), float(v)) for c, v in cands])
            for hf, cands in meta.get("hit_history", [])]
        sys_._last_place_kf = meta.get("last_place_kf", 0)
        sys_.loop_edges = [
            (i, j, np.asarray(Z, np.float32), w)
            for i, j, Z, w in meta["loop_edges"]]
        return sys_

    # ------------------------------------------------------------ final
    def finalize(self, run_pgo: bool = True):
        self._poll(force=True)             # catch a trailing loop hit
        if self._verifying:                # ... and its verification
            self._consume_verifications(force=True)
        if run_pgo and self.loop_edges:
            self._run_pgo(iters=self.cfg.ba.pg_iters)
        return self.poses()

    def poses(self) -> np.ndarray:
        n = self.frame_count + 1
        return np.asarray(self.state.traj[:n])


def _template_state(cam, cfg: SlamConfig, seed: int) -> SlamState:
    """Zero-filled SlamState with the right pytree structure/shapes."""
    h, w = cfg.image.height, cfg.image.width
    z = jnp.zeros((h, w), jnp.float32)
    return _init_state(z, z, cam, cfg, seed)


def run(lefts, rights, cam: StereoCamera, cfg: Optional[SlamConfig] = None,
        seed: int = 0, bow_train_frame: int = 30):
    """Batch API over pre-loaded (F,H,W) stacks. Returns (poses, system)."""
    sys_ = SlamSystem(cam, cfg, seed, bow_train_frame)
    for i in range(lefts.shape[0]):
        sys_.process(lefts[i], rights[i])
    return sys_.finalize(), sys_
