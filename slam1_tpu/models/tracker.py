"""Temporal tracking: 2D(t+1) <-> 3D(t) association + PnP pose update.

Covers the reference chain find_2D_and_3D_correspondenses ->
calculate_transformation_matrix (/root/reference/Point3D.py:33-53,
transformation.py:5-19, main.py:88-95). Differences by design:

  - The descriptor match is the brute-force Hamming matcher, not FLANN.
  - The range gate (ref max_Distance, main.py:90) is applied as a mask.
  - PnP failure does not silently reuse the previous transform inside
    the solver (ref quirk at main.py:94-98); instead `ok=False` is
    surfaced and the caller falls back to a constant-velocity motion
    model explicitly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam1_tpu.config import SlamConfig
from slam1_tpu.ops import hamming, se3
from slam1_tpu.ops.camera import StereoCamera
from slam1_tpu.ops.pnp import PnPResult, ransac_pnp
from slam1_tpu.types import Features, StereoObservations


class TrackResult(NamedTuple):
    pnp: PnPResult
    num_candidates: jnp.ndarray   # matches surviving all gates
    match_idx: jnp.ndarray        # (N,) prev-row -> cur feature index
    match_mask: jnp.ndarray       # (N,)


@functools.partial(jax.jit, static_argnames=("cfg",))
def temporal_track(key, prev_obs: StereoObservations, cur_feats: Features,
                   cam: StereoCamera, cfg: SlamConfig,
                   xi_prior=None) -> TrackResult:
    """Estimate T_cur_prev from prev 3D points and current 2D features."""
    if xi_prior is not None and cfg.tracking.gate_radius_px > 0:
        # Prediction-gated matching: project each prev 3D point under
        # the constant-velocity prior and only let features inside a
        # gate disk compete (hamming.match_windowed) — the ratio test
        # then rejects lookalikes elsewhere in the frame instead of
        # true matches.
        from slam1_tpu.ops.camera import project
        X_pred = se3.transform_points(se3.exp_se3(xi_prior),
                                      prev_obs.xyz)
        uv_pred, _ = project(cam, X_pred)
        m = hamming.match_windowed(
            prev_obs.desc, cur_feats.desc, uv_pred, cur_feats.xy,
            prev_obs.mask, cur_feats.mask,
            radius=cfg.tracking.gate_radius_px,
            ratio=cfg.matcher.ratio,
            max_distance=cfg.matcher.max_hamming,
            cross_check=cfg.matcher.cross_check)
    else:
        m = hamming.match(prev_obs.desc, cur_feats.desc,
                          prev_obs.mask, cur_feats.mask,
                          ratio=cfg.matcher.ratio,
                          max_distance=cfg.matcher.max_hamming,
                          cross_check=cfg.matcher.cross_check)
    # Range gate on the 3D magnitude (ref Point3D.py:44-47).
    ranges = jnp.linalg.norm(prev_obs.xyz, axis=-1)
    rng_ok = ranges < cfg.tracking.max_point_range
    valid = m.mask & prev_obs.mask & rng_ok

    # Close/far weighting (the live version of the reference's unused
    # sort_3D_points, SURVEY C8): far points keep full weight for
    # rotation-rich information only when far_weight == 1.
    close = ranges < cfg.tracking.close_range
    pw = jnp.where(close, 1.0, cfg.tracking.far_weight).astype(
        prev_obs.xyz.dtype)

    uv_cur = cur_feats.xy[m.idx]
    pnp = ransac_pnp(key, prev_obs.xyz, uv_cur, valid, cam, cfg.tracking,
                     xi_init=xi_prior, point_weights=pw)
    return TrackResult(pnp=pnp, num_candidates=jnp.sum(valid),
                       match_idx=m.idx, match_mask=valid)


def chain_pose(T_w_prev, pnp: PnPResult, xi_fallback):
    """World pose update with explicit constant-velocity fallback.

    Returns (T_w_cur, xi_used) where xi_used = log(T_cur_prev).
    """
    xi_meas = se3.log_se3(pnp.T)
    xi_used = jnp.where(pnp.ok, xi_meas, xi_fallback)
    T_rel = se3.exp_se3(xi_used)
    return T_w_prev @ se3.inverse(T_rel), xi_used
