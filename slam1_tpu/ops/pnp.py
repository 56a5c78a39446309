"""PnP pose estimation: vmapped-hypothesis RANSAC + Gauss-Newton refine.

Replaces cv2.solvePnPRansac (/root/reference/transformation.py:5-19) and
the reference VO's sampled-LM loop (visual_odometry.py:135-157). The
data-dependent RANSAC loop becomes a fixed-size batch: K hypotheses are
refined in parallel with vmapped GN on minimal point sets, scored by
inlier count over the full (masked) correspondence set, and the winner
is polished with Huber-IRLS GN — no dynamic control flow, one jit.

Convention: solves T_ba minimizing || proj(T_ba @ X_a) - uv_b || where
X_a are 3D points in camera frame A and uv_b pixels in camera B. The
world pose chains as T_w_b = T_w_a @ inv(T_ba).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam1_tpu.config import TrackingConfig
from slam1_tpu.ops import se3
from slam1_tpu.ops.camera import StereoCamera, project
from slam1_tpu.ops.lsq import huber_weights, solve_spd6


class PnPResult(NamedTuple):
    T: jnp.ndarray            # (4,4) best T_ba
    inliers: jnp.ndarray      # (N,) bool
    num_inliers: jnp.ndarray  # () int32
    mean_err: jnp.ndarray     # () float32 mean inlier reprojection error px
    ok: jnp.ndarray           # () bool — enough support to trust T


def _residuals(xi, X, uv, cam):
    """(2N,) reprojection residuals and validity weights for pose twist."""
    T = se3.exp_se3(xi)
    Xc = se3.transform_points(T, X)
    uv_hat, in_front = project(cam, Xc)
    r = (uv_hat - uv).reshape(-1)
    w = jnp.repeat(in_front, 2)
    return r, w


def _gn_refine(xi0, X, uv, w_pt, cam, iters: int, extra_weights=None):
    """Fixed-iteration damped GN on the 6-dof pose twist."""
    eye = jnp.eye(6, dtype=xi0.dtype)

    def step(xi, _):
        r, w_front = _residuals(xi, X, uv, cam)
        w = w_front * jnp.repeat(w_pt, 2)
        if extra_weights is not None:
            w = w * extra_weights(xi)
        J = jax.jacfwd(lambda z: _residuals(z, X, uv, cam)[0])(xi)
        Jw = J * w[:, None]
        H = J.T @ Jw
        g = Jw.T @ r
        # closed-form blockwise SPD solve instead of jnp.linalg.solve's
        # LU inside the GN scan of every hypothesis
        dx = solve_spd6(H + 1e-5 * eye, g)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        return xi - dx, None

    xi, _ = jax.lax.scan(step, xi0, None, length=iters)
    return xi


def _reproj_err2(xi, X, uv, cam):
    T = se3.exp_se3(xi)
    Xc = se3.transform_points(T, X)
    uv_hat, in_front = project(cam, Xc)
    e2 = jnp.sum((uv_hat - uv) ** 2, axis=-1)
    return jnp.where(in_front, e2, jnp.inf)


@functools.partial(jax.jit, static_argnames=("cfg",))
def ransac_pnp(key, X, uv, mask, cam: StereoCamera, cfg: TrackingConfig,
               xi_init=None, point_weights=None) -> PnPResult:
    """RANSAC PnP over masked correspondences.

    Args:
      X:    (N,3) 3D points in camera frame A.
      uv:   (N,2) observed pixels in camera B.
      mask: (N,)  valid correspondences.
      xi_init: optional (6,) twist prior (e.g. previous frame motion)
        used to seed every hypothesis — KITTI-style smooth motion makes
        GN from a motion prior at 6 points converge in a few steps.
      point_weights: optional (N,) soft weights applied in the polish
        stage (e.g. close/far range weighting, SURVEY C8).
    """
    n = X.shape[0]
    k = cfg.ransac_iters
    s = cfg.ransac_sample
    if xi_init is None:
        xi_init = jnp.zeros((6,), X.dtype)

    # Sample s valid indices per hypothesis (Gumbel top-k over the mask).
    gumbel = -jnp.log(-jnp.log(
        jax.random.uniform(key, (k, n), minval=1e-9, maxval=1.0)))
    scores = jnp.where(mask[None, :], gumbel, -jnp.inf)
    _, samples = jax.lax.top_k(scores, s)                      # (K,s)

    def refine_one(idx):
        Xs = X[idx]
        uvs = uv[idx]
        ws = mask[idx].astype(X.dtype)
        return _gn_refine(xi_init, Xs, uvs, ws, cam, cfg.gn_iters_hypo)

    xis = jax.vmap(refine_one)(samples)                        # (K,6)

    # Score all hypotheses over the full set.
    e2 = jax.vmap(lambda xi: _reproj_err2(xi, X, uv, cam))(xis)  # (K,N)
    thresh2 = cfg.ransac_px_thresh ** 2
    inl = (e2 < thresh2) & mask[None, :]
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)
    xi_best = xis[best]

    # Polish on the inlier set with Huber IRLS weights.
    inl_best = inl[best]

    pw = jnp.ones_like(mask, X.dtype) if point_weights is None \
        else point_weights

    def polish_weights(xi):
        e2p = _reproj_err2(xi, X, uv, cam)
        hw = huber_weights(e2p, cfg.huber_delta)
        return jnp.repeat(hw * inl_best * pw, 2)

    xi_pol = _gn_refine(xi_best, X, uv, mask.astype(X.dtype), cam,
                        cfg.gn_iters_polish, extra_weights=polish_weights)

    e2_pol = _reproj_err2(xi_pol, X, uv, cam)
    inliers = (e2_pol < thresh2) & mask
    num = jnp.sum(inliers)
    # Keep the polished pose only if it didn't lose support.
    use_pol = num >= counts[best]
    xi_final = jnp.where(use_pol, xi_pol, xi_best)
    inliers = jnp.where(use_pol, inliers, inl_best)
    num = jnp.maximum(num, counts[best])
    e2_fin = _reproj_err2(xi_final, X, uv, cam)
    mean_err = jnp.sqrt(
        jnp.sum(jnp.where(inliers, e2_fin, 0.0))
        / jnp.maximum(num, 1)).astype(X.dtype)
    ok = num >= cfg.min_track_points
    return PnPResult(T=se3.exp_se3(xi_final), inliers=inliers,
                     num_inliers=num, mean_err=mean_err, ok=ok)
