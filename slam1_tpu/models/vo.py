"""Stereo visual odometry: the minimum end-to-end slice.

The counterpart of both reference frontends — the main SLAM
loop's odometry core (/root/reference/main.py:76-122) and the standalone
`visual_odometry.py` VO (SURVEY.md C18). One jitted `vo_step` fuses
detect -> stereo match -> triangulate -> temporal match -> RANSAC-PnP ->
pose chaining; the host loop only feeds images and collects metrics
(sequential dependence of tracking is inherent — throughput comes from
everything inside the step being batched on-device).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam1_tpu.config import SlamConfig
from slam1_tpu.models.frontend import stereo_frontend
from slam1_tpu.models.tracker import chain_pose, temporal_track
from slam1_tpu.ops.camera import StereoCamera
from slam1_tpu.types import StereoObservations


class VOState(NamedTuple):
    T_w_cam: jnp.ndarray          # (4,4) current world-from-camera pose
    prev_obs: StereoObservations  # previous frame's triangulated features
    xi_vel: jnp.ndarray           # (6,) last relative twist (motion prior)
    key: jnp.ndarray              # PRNG state for RANSAC sampling
    frame: jnp.ndarray            # () int32


class VOMetrics(NamedTuple):
    num_stereo: jnp.ndarray       # triangulated stereo matches
    num_temporal: jnp.ndarray     # temporal correspondences
    num_inliers: jnp.ndarray
    mean_reproj_err: jnp.ndarray
    pnp_ok: jnp.ndarray


def init_state(left, right, cam: StereoCamera, cfg: SlamConfig,
               seed: int = 0) -> VOState:
    """Bootstrap from the first stereo pair (ref main.py:75)."""
    _, obs = stereo_frontend(left, right, cam, cfg)
    return VOState(
        T_w_cam=jnp.eye(4, dtype=left.dtype),
        prev_obs=obs,
        xi_vel=jnp.zeros(6, left.dtype),
        key=jax.random.PRNGKey(seed),
        frame=jnp.asarray(0, jnp.int32),
    )


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def vo_step(state: VOState, left, right, cam: StereoCamera,
            cfg: SlamConfig):
    """Process one new stereo pair; returns (new_state, metrics)."""
    key, sub = jax.random.split(state.key)
    feats, obs = stereo_frontend(left, right, cam, cfg)
    track = temporal_track(sub, state.prev_obs, feats, cam, cfg,
                           xi_prior=state.xi_vel)
    T_w, xi_used = chain_pose(state.T_w_cam, track.pnp, state.xi_vel)

    new_state = VOState(
        T_w_cam=T_w,
        prev_obs=obs,
        xi_vel=xi_used,
        key=key,
        frame=state.frame + 1,
    )
    metrics = VOMetrics(
        num_stereo=jnp.sum(obs.mask),
        num_temporal=track.num_candidates,
        num_inliers=track.pnp.num_inliers,
        mean_reproj_err=track.pnp.mean_err,
        pnp_ok=track.pnp.ok,
    )
    return new_state, metrics


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def vo_block(state: VOState, lefts, rights, cam: StereoCamera,
             cfg: SlamConfig):
    """K frames of VO in ONE dispatched program (lax.scan over vo_step's
    body), paying the per-program dispatch cost once per K frames (see
    models/pipeline.slam_step_block). Returns
    (state, poses (K,4,4), metrics stacked over K)."""
    def body(s, lr):
        key, sub = jax.random.split(s.key)
        feats, obs = stereo_frontend(lr[0], lr[1], cam, cfg)
        track = temporal_track(sub, s.prev_obs, feats, cam, cfg,
                               xi_prior=s.xi_vel)
        T_w, xi_used = chain_pose(s.T_w_cam, track.pnp, s.xi_vel)
        s2 = VOState(T_w_cam=T_w, prev_obs=obs, xi_vel=xi_used, key=key,
                     frame=s.frame + 1)
        m = VOMetrics(
            num_stereo=jnp.sum(obs.mask),
            num_temporal=track.num_candidates,
            num_inliers=track.pnp.num_inliers,
            mean_reproj_err=track.pnp.mean_err,
            pnp_ok=track.pnp.ok)
        return s2, (T_w, m)
    state, (poses, metrics) = jax.lax.scan(body, state, (lefts, rights))
    return state, poses, metrics


def run_sequence(lefts, rights, cam: StereoCamera, cfg: SlamConfig,
                 seed: int = 0):
    """Host driver: sequential VO over (F,H,W) stacks.

    Returns (poses (F,4,4) numpy, metrics list).
    """
    import numpy as np

    state = init_state(lefts[0], rights[0], cam, cfg, seed)
    # Buffer device-side per-frame outputs and pull them in ONE transfer
    # at the end: np.asarray(...) inside the loop would force a host
    # sync every frame and serialize dispatch against the device.
    # (vo_step donates the state, so snapshot the pose with a device
    # copy — holding the donated buffer itself would be invalidated by
    # the next step.)
    poses_dev = [jnp.copy(state.T_w_cam)]
    metrics_dev = []
    for i in range(1, lefts.shape[0]):
        state, m = vo_step(state, lefts[i], rights[i], cam, cfg)
        poses_dev.append(jnp.copy(state.T_w_cam))
        metrics_dev.append(m)
    poses, metrics = jax.device_get((poses_dev, metrics_dev))
    return np.stack(poses), metrics
