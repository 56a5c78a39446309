"""Alternative stereo VO frontend: FAST corners + LK optical flow + dense
disparity (SURVEY.md C18).

The counterpart of the reference's second, self-contained VO
(/root/reference/visual_odometry.py:12-192): tiled FAST keypoints (:83-96),
pyramidal LK temporal tracking (:98-111), SGBM disparity lookups to
synthesize right-image coordinates (:113-126), triangulation of both time
steps (:128-133) and pose estimation from the 3D(t) <-> 2D(t+1)
correspondences. The reference's sampled-LM RANSAC (:135-157 — repeated
6-point scipy LM solves with early stopping) is exactly what
ops/pnp.ransac_pnp does as a fixed-size vmapped hypothesis batch.

Unlike models/vo.py (descriptor matching), this path never builds
descriptors: temporal correspondence comes from optical flow and stereo
correspondence from the dense disparity map, so it exercises ops/lk.py
and ops/disparity.py end-to-end.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam1_tpu.config import SlamConfig
from slam1_tpu.models.tracker import chain_pose
from slam1_tpu.ops import disparity as disp_ops
from slam1_tpu.ops import lk, pnp, triangulate
from slam1_tpu.ops.brief import gaussian_blur
from slam1_tpu.ops.camera import StereoCamera
from slam1_tpu.ops.detector import detect


class FlowVOState(NamedTuple):
    T_w_cam: jnp.ndarray    # (4,4) world-from-camera
    prev_left: jnp.ndarray  # (H,W) previous left image, LK-smoothed
    prev_xy: jnp.ndarray    # (N,2) keypoints detected in prev left
    prev_mask: jnp.ndarray  # (N,)
    prev_disp: jnp.ndarray  # (H,W) previous disparity map
    prev_dvalid: jnp.ndarray
    xi_vel: jnp.ndarray     # (6,) motion prior
    key: jnp.ndarray
    frame: jnp.ndarray


class FlowVOMetrics(NamedTuple):
    num_tracked: jnp.ndarray
    num_stereo: jnp.ndarray
    num_inliers: jnp.ndarray
    mean_reproj_err: jnp.ndarray
    pnp_ok: jnp.ndarray


def _detect_corners(img, cfg: SlamConfig):
    f = detect(img, cfg.detector, cfg.image.valid_height,
               cfg.image.valid_width)
    return f.xy, f.mask


def _smooth_for_lk(img, cfg: SlamConfig):
    s = cfg.flow.blur_sigma
    return gaussian_blur(img, s) if s > 0 else img


def _dense_disparity(left, right, cfg: SlamConfig):
    d = cfg.disparity
    return disp_ops.disparity(left, right, max_disp=d.max_disp,
                              radius=d.radius, sgm=d.sgm, p1=d.p1, p2=d.p2,
                              lr_check=d.lr_check, lr_tol=d.lr_tol,
                              uniq_ratio=d.uniq_ratio)


def init_state(left, right, cam: StereoCamera, cfg: SlamConfig,
               seed: int = 0) -> FlowVOState:
    """Bootstrap: detect frame-0 corners, precompute frame-0 disparity
    (ref visual_odometry.py:22-23)."""
    xy, mask = _detect_corners(left, cfg)
    d = _dense_disparity(left, right, cfg)
    left_s = _smooth_for_lk(left, cfg)
    return FlowVOState(
        T_w_cam=jnp.eye(4, dtype=left.dtype),
        prev_left=left_s, prev_xy=xy, prev_mask=mask,
        prev_disp=d.disp, prev_dvalid=d.valid,
        xi_vel=jnp.zeros(6, left.dtype),
        key=jax.random.PRNGKey(seed),
        frame=jnp.asarray(0, jnp.int32))


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def vo_step(state: FlowVOState, left, right, cam: StereoCamera,
            cfg: SlamConfig):
    """Process one stereo pair -> (new_state, metrics).

    Mirrors the reference get_pose chain (visual_odometry.py:185-192):
    track prev->cur, disparity-gate both endpoints, triangulate the
    PREVIOUS frame's 3D points, PnP them against the CURRENT 2D tracks.
    """
    key, sub = jax.random.split(state.key)
    fcfg = cfg.flow
    left_s = _smooth_for_lk(left, cfg)

    # Temporal LK tracking of the previous frame's corners.
    tr = lk.lk_track(state.prev_left, left_s, state.prev_xy, state.prev_mask,
                     win=fcfg.win, levels=fcfg.levels, iters=fcfg.iters,
                     max_err=fcfg.max_err)
    q1, q2 = state.prev_xy, tr.xy

    # Right-image coordinates of the PREVIOUS frame endpoints via the
    # held disparity map (ref calculate_right_qs, :113-126).
    prev_d = disp_ops.DisparityResult(state.prev_disp, state.prev_dvalid)
    d1, d1_ok = disp_ops.sample_disparity(prev_d, q1)
    stereo_ok = tr.mask & d1_ok & (d1 > 0.0) \
        & (d1 < cfg.disparity.max_disp - 1.0)
    uv_r1 = q1 - jnp.stack([d1, jnp.zeros_like(d1)], axis=-1)

    # Triangulate previous-frame 3D points; PnP against current tracks.
    X1, tri_ok = triangulate.stereo_rectified(
        cam, q1, uv_r1, min_disparity=cfg.matcher.min_disparity)
    corr_ok = stereo_ok & tri_ok
    res = pnp.ransac_pnp(sub, X1, q2, corr_ok, cam, cfg.tracking,
                         xi_init=state.xi_vel)
    T_w, xi_used = chain_pose(state.T_w_cam, res, state.xi_vel)

    # Prepare next state: fresh corners + disparity for the new frame.
    xy, mask = _detect_corners(left, cfg)
    d = _dense_disparity(left, right, cfg)

    new_state = FlowVOState(
        T_w_cam=T_w, prev_left=left_s, prev_xy=xy, prev_mask=mask,
        prev_disp=d.disp, prev_dvalid=d.valid, xi_vel=xi_used,
        key=key, frame=state.frame + 1)
    metrics = FlowVOMetrics(
        num_tracked=jnp.sum(tr.mask),
        num_stereo=jnp.sum(corr_ok),
        num_inliers=res.num_inliers,
        mean_reproj_err=res.mean_err,
        pnp_ok=res.ok)
    return new_state, metrics


def run_sequence(lefts, rights, cam: StereoCamera, cfg: SlamConfig,
                 seed: int = 0):
    """Host driver over (F,H,W) stacks -> (poses (F,4,4) numpy, metrics)."""
    import numpy as np

    state = init_state(lefts[0], rights[0], cam, cfg, seed)
    poses = [np.eye(4, dtype=np.float32)]
    metrics = []
    for i in range(1, lefts.shape[0]):
        state, m = vo_step(state, lefts[i], rights[i], cam, cfg)
        poses.append(np.asarray(state.T_w_cam))
        metrics.append(jax.tree.map(np.asarray, m))
    return np.stack(poses), metrics
