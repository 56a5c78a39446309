"""Pyramidal Lucas-Kanade sparse optical flow.

Replacement for cv2.calcOpticalFlowPyrLK, used by the
reference's alternative frontend (/root/reference/visual_odometry.py:26-29
and :98-111, also tracking.py:37-53 and keypoint.py:13-32). The
data-dependent per-point loops become: a static Python loop over pyramid
levels, a lax.scan over solver iterations, and a vmap over keypoints —
patch sampling is batched bilinear gathers, and each point solves its own
2x2 normal equations (elementwise work; thousands of points in one
launch).

Status semantics follow the reference's usage: a track survives if the
final per-patch photometric error is below `max_err` and the tracked
point stays inside the image (visual_odometry.py:104-110 filters on
err < 4 over uint8 images; images here are float in [0,1], so the
equivalent default is 4/255).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class FlowResult(NamedTuple):
    xy: jnp.ndarray     # (N,2) tracked positions in the next image
    err: jnp.ndarray    # (N,)  mean |I_prev - I_next| over the window
    mask: jnp.ndarray   # (N,)  track survived (valid input & err & bounds)


def bilinear(img, xy):
    """Bilinear sample an (H,W) image at (...,2) float (x,y) coords.

    Coordinates are clamped to the valid interpolation domain.
    """
    h, w = img.shape
    x = jnp.clip(xy[..., 0], 0.0, w - 1.001)
    y = jnp.clip(xy[..., 1], 0.0, h - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def _downsample2(img):
    """2x box-filtered decimation (pyramid level)."""
    h, w = img.shape
    h2, w2 = h // 2, w // 2
    img = img[:h2 * 2, :w2 * 2]
    return img.reshape(h2, 2, w2, 2).mean(axis=(1, 3))


def build_pyramid(img, levels: int):
    """[level0 (full res), level1 (half), ...] — static list of arrays."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(_downsample2(pyr[-1]))
    return pyr


def _window_offsets(win: int, dtype):
    r = win // 2
    o = jnp.arange(-r, r + 1, dtype=dtype)
    oy, ox = jnp.meshgrid(o, o, indexing="ij")
    return jnp.stack([ox.reshape(-1), oy.reshape(-1)], axis=-1)  # (win*win,2)


def _track_level(prev, nxt, pts, guess, win: int, iters: int):
    """One pyramid level of iterative LK for all points.

    pts:   (N,2) point positions at THIS level's resolution (prev image).
    guess: (N,2) current flow estimate at this level's resolution.
    Returns (flow (N,2), err (N,)).
    """
    offs = _window_offsets(win, pts.dtype)                  # (W2,2)

    def per_point(p, g):
        grid = p[None, :] + offs                            # (W2,2)
        t = bilinear(prev, grid)                            # template
        # Spatial gradients of the TEMPLATE (inverse-compositional-style:
        # constant across iterations, so G is factored out of the loop).
        dx = jnp.array([0.5, 0.0], pts.dtype)
        dy = jnp.array([0.0, 0.5], pts.dtype)
        ix = bilinear(prev, grid + dx) - bilinear(prev, grid - dx)
        iy = bilinear(prev, grid + dy) - bilinear(prev, grid - dy)
        gxx = jnp.sum(ix * ix)
        gxy = jnp.sum(ix * iy)
        gyy = jnp.sum(iy * iy)
        det = gxx * gyy - gxy * gxy
        inv_ok = det > 1e-8
        det = jnp.where(inv_ok, det, 1.0)
        # G^-1, closed form 2x2.
        i00, i01, i11 = gyy / det, -gxy / det, gxx / det

        def step(v, _):
            cur = bilinear(nxt, grid + v[None, :])
            d = t - cur
            bx = jnp.sum(d * ix)
            by = jnp.sum(d * iy)
            dv = jnp.stack([i00 * bx + i01 * by, i01 * bx + i11 * by])
            dv = jnp.where(inv_ok, dv, 0.0)
            return v + dv, None

        v, _ = jax.lax.scan(step, g, None, length=iters)
        cur = bilinear(nxt, grid + v[None, :])
        err = jnp.mean(jnp.abs(t - cur))
        return v, err

    return jax.vmap(per_point)(pts, guess)


@functools.partial(jax.jit, static_argnames=("win", "levels", "iters"))
def lk_track(prev, nxt, pts, mask, win: int = 11, levels: int = 3,
             iters: int = 10, max_err: float = 4.0 / 255.0) -> FlowResult:
    """Track (N,2) points from `prev` to `nxt` (both (H,W) float [0,1])."""
    h, w = prev.shape
    pyr_p = build_pyramid(prev, levels)
    pyr_n = build_pyramid(nxt, levels)

    flow = jnp.zeros_like(pts)
    err = jnp.zeros(pts.shape[0], pts.dtype)
    for lv in range(levels - 1, -1, -1):
        s = pts.dtype.type(2.0 ** lv)
        flow_lv, err = _track_level(pyr_p[lv], pyr_n[lv], pts / s,
                                    flow / s, win, iters)
        flow = flow_lv * s

    new_xy = pts + flow
    r = win // 2 + 1
    inb = ((new_xy[:, 0] >= r) & (new_xy[:, 0] < w - r)
           & (new_xy[:, 1] >= r) & (new_xy[:, 1] < h - r))
    ok = mask & inb & (err < max_err) & jnp.all(jnp.isfinite(new_xy), -1)
    return FlowResult(xy=new_xy, err=err, mask=ok)
