"""Tiled feature detection: FAST score -> NMS -> per-tile top-k -> oriented
rBRIEF descriptors, with fixed output capacity.

Replaces the reference's tiled ORB (/root/reference/orb.py:4-25): instead
of 50%-overlapping tiles with per-tile cv2.ORB calls and ragged keypoint
lists, the score map is computed once for the whole image and a
reshape+top_k harvests exactly `kp_per_tile` candidates per grid cell
(invalid slots masked) — same spatial-spread effect, static shapes, one
kernel launch. Per-pixel NMS also subsumes the reference's duplicate-
keypoint removal (keypoint.py:83-98).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from slam1_tpu.config import DetectorConfig
from slam1_tpu.ops import brief, fast
from slam1_tpu.types import Features


def _extract_patches_tiled(blurred, ty, tx, gr: int, gc: int, th: int,
                           tw: int, patch: int):
    """(P,P) patches for per-tile keypoints via tile-local one-hot matmuls.

    ty/tx: (T, k) int32 tile-local keypoint coords, T = gr*gc.

    Keypoints come from a per-tile top-k, so instead of a per-keypoint
    patch gather the selection is expressed as two one-hot contractions
    against each keypoint's own (th+patch-1, tw+patch-1) halo tile.
    Exact up to matmul rounding (one nonzero term per one-hot row).
    """
    m = patch // 2
    h, w = blurred.shape
    ph, pw = th * gr, tw * gc
    hh, hw_ = th + 2 * m, tw + 2 * m
    bp = jnp.pad(blurred, ((m, m + ph - h), (m, m + pw - w)))
    bands = jnp.stack([bp[r * th:r * th + hh, :] for r in range(gr)])
    tiles = jnp.stack([bands[:, :, c * tw:c * tw + hw_] for c in range(gc)],
                      axis=1)                       # (gr, gc, HH, HW)
    timg = tiles.reshape(gr * gc, hh, hw_)

    offs = jnp.arange(patch)
    rows = ty[:, :, None] + offs                    # (T,k,P) in [0, th+2m)
    cols = tx[:, :, None] + offs
    dt = blurred.dtype
    r1 = (rows[..., None] == jnp.arange(hh)).astype(dt)    # (T,k,P,HH)
    c1 = (cols[..., None] == jnp.arange(hw_)).astype(dt)   # (T,k,P,HW)
    # DEFAULT precision (TF32 on the GPU), overriding the global
    # "highest" pin (runtime.py): selection matmuls have one nonzero
    # term per row, so the only error is the rounding of the pixel
    # value (2^-11 in TF32), irrelevant to corner patches.
    prec = jax.lax.Precision.DEFAULT
    u = jnp.einsum("tkph,thw->tkpw", r1, timg, precision=prec)
    patches = jnp.einsum("tkpw,tkqw->tkpq", u, c1, precision=prec)
    return patches.reshape(-1, patch, patch)


@functools.partial(jax.jit, static_argnames=("cfg",))
def detect(img, cfg: DetectorConfig, valid_h=None, valid_w=None) -> Features:
    """Detect + describe on one (H,W) float32 image.

    valid_h/valid_w (traced or static) bound the usable region of a
    padded canvas; detections outside are suppressed.
    """
    h, w = img.shape
    margin = cfg.patch_size // 2 + 1
    if valid_h is None:
        valid_h = h
    if valid_w is None:
        valid_w = w

    raw = fast.fast_score(img, cfg.fast_threshold, arc=cfg.fast_arc)
    score = fast.nms(raw, cfg.nms_radius)

    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inside = ((ys >= margin) & (ys < valid_h - margin)
              & (xs >= margin) & (xs < valid_w - margin))
    score = jnp.where(inside, score, 0.0)

    # Per-tile top-k. Tile edges must divide the canvas; pad score with
    # zeros if not.
    th = -(-h // cfg.grid_rows)
    tw = -(-w // cfg.grid_cols)
    ph, pw = th * cfg.grid_rows, tw * cfg.grid_cols
    score_p = jnp.pad(score, ((0, ph - h), (0, pw - w)))
    tiles = score_p.reshape(cfg.grid_rows, th, cfg.grid_cols, tw)
    tiles = tiles.transpose(0, 2, 1, 3).reshape(-1, th * tw)
    top_scores, top_idx = jax.lax.top_k(tiles, cfg.kp_per_tile)  # (T,k)

    tile_r = jnp.arange(cfg.grid_rows * cfg.grid_cols) // cfg.grid_cols
    tile_c = jnp.arange(cfg.grid_rows * cfg.grid_cols) % cfg.grid_cols
    ty = top_idx // tw                              # tile-local coords
    tx = top_idx % tw
    y = ty + (tile_r * th)[:, None]
    x = tx + (tile_c * tw)[:, None]

    # Subpixel refinement: 1D quadratic fit of the PRE-NMS score along
    # each axis. Integer corner positions quantize stereo disparity by
    # +-0.5 px at level 0 and +-2^l px at pyramid level l; the 1/d of
    # triangulation turns that symmetric noise into a SYSTEMATIC depth
    # overestimate (Jensen) that integrates into a few-percent VO
    # translation-scale bias (measured +2-4% on the 2000-frame scale
    # clip). Where a neighbor fails the FAST corner gate its score is 0
    # and the fit degenerates to offset 0 — no harm, no refinement.
    yf = y.reshape(-1)
    xf = x.reshape(-1)
    yc = jnp.clip(yf, 1, h - 2)
    xc = jnp.clip(xf, 1, w - 2)
    s0 = raw[yc, xc]

    def _paraboff(m, p, c):
        den = m + p - 2.0 * c
        t = 0.5 * (m - p) / jnp.where(jnp.abs(den) > 1e-9, den, 1.0)
        return jnp.clip(jnp.where(jnp.abs(den) > 1e-9, t, 0.0),
                        -0.5, 0.5)

    dx = _paraboff(raw[yc, xc - 1], raw[yc, xc + 1], s0)
    dy = _paraboff(raw[yc - 1, xc], raw[yc + 1, xc], s0)
    xy = jnp.stack([xf.astype(img.dtype) + dx,
                    yf.astype(img.dtype) + dy], axis=-1)
    scores = top_scores.reshape(-1)
    mask = scores > 0.0

    blurred = brief.gaussian_blur(img, cfg.blur_sigma)
    patches = _extract_patches_tiled(blurred, ty, tx, cfg.grid_rows,
                                     cfg.grid_cols, th, tw, cfg.patch_size)
    angles = brief.orientation(patches)
    # Quantize steering to 30 deg bins (cv2 ORB steers its pattern in
    # discrete increments for the same reason): the intensity-centroid
    # angle carries a few degrees of view-dependent noise, and steering
    # the 256-pair pattern by two slightly-different angles flips a
    # large fraction of bits between two views of the SAME feature —
    # within-bin noise now yields bit-identical descriptors, and BRIEF
    # tolerates the residual <=15 deg rotation mismatch by design.
    bin_w = 2.0 * jnp.pi / 12.0
    angles = jnp.round(angles / bin_w) * bin_w
    pattern = _pattern_for(cfg)
    desc = brief._describe(patches, angles, pattern, cfg.brief_pairs)

    return Features(xy=xy, score=scores, angle=angles, desc=desc, mask=mask)


def _downsample2(img):
    """Exact 2x2 average pool (the antialiased half-octave step); odd
    trailing rows/cols are edge-padded first."""
    h, w = img.shape
    ph, pw = h % 2, w % 2
    if ph or pw:
        img = jnp.pad(img, ((0, ph), (0, pw)), mode="edge")
    h2, w2 = img.shape
    return img.reshape(h2 // 2, 2, w2 // 2, 2).mean(axis=(1, 3))


@functools.partial(jax.jit, static_argnames=("cfg",))
def detect_pyramid(img, cfg: DetectorConfig, valid_h=None,
                   valid_w=None) -> Features:
    """Multi-scale detect + describe (ref orb.py:29-33: cv2.ORB with 8
    levels, scaleFactor 1.2; here: `cfg.num_levels` octaves at
    `cfg.scale_factor`, static shapes per level).

    Level l is the image downsampled by s**l; detection uses a grid
    shrunk by the same factor (constant tile size in pixels), and the
    descriptor is computed on the DOWNSAMPLED image — that is what buys
    scale invariance: a 2x-closer view of the same surface produces the
    same patch at one level up. Keypoint coordinates are mapped back to
    full resolution (x_full = s*x + (s-1)/2 for the pool's pixel-center
    shift). Output capacity = cfg.max_kp (sum of per-level capacities).
    """
    import dataclasses
    h, w = img.shape
    if valid_h is None:
        valid_h = h
    if valid_w is None:
        valid_w = w

    pow2 = abs(cfg.scale_factor - 2.0) < 1e-9
    feats = []
    cur = img
    for lvl in range(cfg.num_levels):
        s = cfg.scale_factor ** lvl
        if lvl > 0:
            if pow2:
                cur = _downsample2(cur)
            else:
                nh = max(16, round(h / s))
                nw = max(16, round(w / s))
                cur = jax.image.resize(img, (nh, nw), "linear",
                                       antialias=True)
        gr, gc = cfg.level_grid(lvl)
        lcfg = dataclasses.replace(cfg, grid_rows=gr, grid_cols=gc,
                                   num_levels=1)
        f = detect(cur, lcfg,
                   valid_h=(valid_h / s).astype(jnp.int32)
                   if hasattr(valid_h, "dtype") else int(valid_h / s),
                   valid_w=(valid_w / s).astype(jnp.int32)
                   if hasattr(valid_w, "dtype") else int(valid_w / s))
        if lvl > 0:
            f = f._replace(xy=f.xy * s + (s - 1.0) / 2.0)
        feats.append(f)
    if len(feats) == 1:
        return feats[0]
    out = jax.tree.map(lambda *a: jnp.concatenate(a, axis=0), *feats)
    # Pad capacity to a multiple of 128 with masked slots: 128 is the
    # column tile of the fused Hamming kernel (ops/pallas_kernels.py),
    # which otherwise pads B itself.
    n = out.mask.shape[0]
    pad = (-n) % 128
    if pad:
        out = jax.tree.map(
            lambda a: jnp.concatenate(
                [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], axis=0),
            out)
    return out


@functools.lru_cache(maxsize=8)
def _pattern_np(n_pairs, radius, seed):
    return brief.make_pattern(n_pairs, radius, seed)


def _pattern_for(cfg: DetectorConfig):
    return jnp.asarray(_pattern_np(cfg.brief_pairs, cfg.brief_radius,
                                   cfg.pattern_seed))


def detect_batch(imgs, cfg: DetectorConfig, valid_h=None, valid_w=None):
    """vmapped detect over a leading batch axis."""
    return jax.vmap(lambda im: detect(im, cfg, valid_h, valid_w))(imgs)
