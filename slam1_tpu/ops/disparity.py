"""Rectified-stereo dense disparity: block matching + semi-global
aggregation.

Replacement for cv2.StereoSGBM (used by the reference's
alternative frontend, /root/reference/visual_odometry.py:19-23 with
block=11 and 32 disparities, consumed at :113-126 as a per-keypoint
lookup to synthesize right-image coordinates). Design:

  - cost volume (D,H,W) by ZSAD over a box window: the per-disparity
    shift is a static roll, the window sum a separable box filter —
    pure dense elementwise/reduction work that XLA fuses and tiles;
  - optional 2-pass semi-global aggregation along scanlines (the
    "SG" in SGBM): a lax.scan over image columns, left->right and
    right->left, carrying the (H,D) aggregated-cost slice with the
    standard P1/P2 smoothness recursion;
  - winner-take-all argmin + parabolic sub-pixel refinement;
  - left-right consistency check by re-using the SAME cost volume
    indexed from the right image (no second matching pass).

Invalid pixels (failed LR check, window out of bounds, disparity at the
search edge) get disparity = -1, matching the reference's "0 < d < max"
validity gate (visual_odometry.py:113-126).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class DisparityResult(NamedTuple):
    disp: jnp.ndarray   # (H,W) float32 left-image disparity; -1 = invalid
    valid: jnp.ndarray  # (H,W) bool


def _box_filter(img, radius: int):
    """Separable (2r+1)^2 box sum via cumulative sums (O(HW), no conv)."""
    k = 2 * radius + 1
    p = jnp.pad(img, ((radius + 1, radius), (radius + 1, radius)))
    c = jnp.cumsum(jnp.cumsum(p, axis=-2), axis=-1)
    return (c[..., k:, k:] - c[..., :-k, k:]
            - c[..., k:, :-k] + c[..., :-k, :-k])


def _cost_volume(left, right, max_disp: int, radius: int):
    """(D,H,W) ZSAD matching cost; out-of-range columns get +inf."""
    k2 = (2 * radius + 1) ** 2
    mu_l = _box_filter(left, radius) / k2
    mu_r = _box_filter(right, radius) / k2
    zl = left - mu_l
    w = left.shape[-1]
    xs = jnp.arange(w)

    def cost_d(d):
        r_sh = jnp.roll(right, d, axis=-1)
        mu_sh = jnp.roll(mu_r, d, axis=-1)
        sad = _box_filter(jnp.abs(zl - (r_sh - mu_sh)), radius)
        return jnp.where(xs[None, :] >= d + radius, sad, jnp.inf)

    return jnp.stack([cost_d(d) for d in range(max_disp)])


def _sgm_pass(cost_hwd, p1: float, p2: float, reverse: bool):
    """One horizontal SGM pass over a (H,W,D) cost volume (scan over W)."""
    c = jnp.swapaxes(cost_hwd, 0, 1)                        # (W,H,D)
    if reverse:
        c = c[::-1]
    big = jnp.asarray(jnp.inf, c.dtype)

    def step(prev, cost_col):                               # prev: (H,D)
        m = jnp.min(prev, axis=-1, keepdims=True)           # (H,1)
        up = jnp.concatenate([prev[:, 1:], jnp.full_like(prev[:, :1], big)],
                             axis=-1)
        dn = jnp.concatenate([jnp.full_like(prev[:, :1], big), prev[:, :-1]],
                             axis=-1)
        agg = jnp.minimum(jnp.minimum(prev, m + p2),
                          jnp.minimum(up + p1, dn + p1))
        out = cost_col + agg - m
        # inf + finite stays inf; guard inf - inf.
        out = jnp.where(jnp.isfinite(cost_col), out, big)
        init_ok = jnp.isfinite(m)[:, 0]
        out = jnp.where(init_ok[:, None], out, cost_col)
        return out, out

    _, agg = jax.lax.scan(step, c[0], c[1:])
    agg = jnp.concatenate([c[:1], agg], axis=0)             # (W,H,D)
    if reverse:
        agg = agg[::-1]
    return jnp.swapaxes(agg, 0, 1)                          # (H,W,D)


@functools.partial(jax.jit,
                   static_argnames=("max_disp", "radius", "sgm", "lr_check"))
def disparity(left, right, max_disp: int = 64, radius: int = 5,
              sgm: bool = True, p1: float = 0.03, p2: float = 0.45,
              lr_check: bool = True, lr_tol: float = 1.0,
              uniq_ratio: float = 0.98) -> DisparityResult:
    """Dense left-image disparity of a rectified float [0,1] pair."""
    h, w = left.shape
    vol = _cost_volume(left, right, max_disp, radius)       # (D,H,W)

    if sgm:
        hwd = jnp.transpose(vol, (1, 2, 0))                 # (H,W,D)
        scale = (2 * radius + 1) ** 2
        acc = (_sgm_pass(hwd, p1 * scale, p2 * scale, False)
               + _sgm_pass(hwd, p1 * scale, p2 * scale, True))
        vol = jnp.transpose(acc, (2, 0, 1))

    d_best = jnp.argmin(vol, axis=0)                        # (H,W)
    dgrid = jnp.arange(max_disp)[:, None, None]
    c_best = jnp.min(vol, axis=0)

    # Uniqueness: best must beat the runner-up (excluding +-1 neighbours).
    near = jnp.abs(dgrid - d_best[None]) <= 1
    c_second = jnp.min(jnp.where(near, jnp.inf, vol), axis=0)
    unique = c_best <= uniq_ratio * c_second

    # Parabolic sub-pixel refinement around the winner.
    def at(dd):
        return jnp.take_along_axis(vol, dd[None], axis=0)[0]
    dm = at(jnp.clip(d_best - 1, 0, max_disp - 1))
    dp = at(jnp.clip(d_best + 1, 0, max_disp - 1))
    denom = dm - 2.0 * c_best + dp
    offs = jnp.where(jnp.abs(denom) > 1e-9,
                     0.5 * (dm - dp) / jnp.where(denom == 0, 1.0, denom),
                     0.0)
    offs = jnp.clip(offs, -0.5, 0.5)
    disp = d_best.astype(left.dtype) + offs

    valid = ((d_best > 0) & (d_best < max_disp - 1)
             & jnp.isfinite(c_best) & unique)

    if lr_check:
        # Right-image disparity from the same volume: costR[d,y,x] =
        # costL[d,y,x+d] (gather along W), then WTA.
        xs = jnp.arange(w)
        xr = jnp.clip(xs[None, None, :] + dgrid, 0, w - 1)  # (D,1,W)
        vol_r = jnp.take_along_axis(vol, jnp.broadcast_to(
            xr, vol.shape), axis=-1)
        vol_r = jnp.where(xs[None, None, :] + dgrid < w, vol_r, jnp.inf)
        d_right = jnp.argmin(vol_r, axis=0)                 # (H,W)
        # d_left(x) must agree with d_right(x - d_left(x)).
        x_in_r = jnp.clip(xs[None, :] - d_best, 0, w - 1)
        d_back = jnp.take_along_axis(d_right, x_in_r, axis=-1)
        valid = valid & (jnp.abs(d_back - d_best) <= lr_tol)

    disp = jnp.where(valid, disp, -1.0)
    return DisparityResult(disp=disp, valid=valid)


def sample_disparity(result: DisparityResult, xy):
    """Per-keypoint disparity lookup (nearest pixel), the counterpart of
    the reference's calculate_right_qs (visual_odometry.py:113-126).

    Returns (disp (N,), valid (N,)).
    """
    h, w = result.disp.shape
    x = jnp.clip(jnp.round(xy[..., 0]).astype(jnp.int32), 0, w - 1)
    y = jnp.clip(jnp.round(xy[..., 1]).astype(jnp.int32), 0, h - 1)
    d = result.disp[y, x]
    return d, result.valid[y, x]
