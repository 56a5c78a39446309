"""Orientation (intensity centroid) + steered rBRIEF 256-bit descriptors.

Replacement for cv2.ORB's description stage (reference
/root/reference/orb.py:28-38 relies on OpenCV's compiled rBRIEF). The
sampling pattern is NOT OpenCV's learned table (no code copied); it is a
fixed seeded Gaussian pattern clipped to a disk, which gives descriptors
with the same matching behaviour inside this framework (both sides of
every match use the same pattern).

All stages are batched over keypoints: patch extraction is one gather,
orientation a masked moment reduction, descriptor sampling two gathers —
no per-keypoint Python.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def make_pattern(n_pairs: int = 256, radius: float = 13.0,
                 seed: int = 1234) -> np.ndarray:
    """(n_pairs, 2, 2) float32 (dx, dy) sample-pair offsets within a disk."""
    rng = np.random.RandomState(seed)
    pts = rng.normal(0.0, radius * 0.45, size=(n_pairs * 4, 2))
    pts = pts[np.linalg.norm(pts, axis=1) <= radius][:n_pairs * 2]
    while len(pts) < n_pairs * 2:  # pragma: no cover (overdraw covers this)
        extra = rng.normal(0.0, radius * 0.45, size=(n_pairs, 2))
        extra = extra[np.linalg.norm(extra, axis=1) <= radius]
        pts = np.concatenate([pts, extra])[:n_pairs * 2]
    return pts.reshape(n_pairs, 2, 2).astype(np.float32)


def gaussian_blur(img, sigma: float = 1.4, ksize: int = 7):
    """Separable Gaussian blur of an (H,W) image (descriptor smoothing,
    the counterpart of OpenCV ORB's integral-image box blur).

    Implemented as 2*ksize statically-shifted weighted adds — elementwise
    work that XLA fuses into two passes over the image.
    """
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    h, w = img.shape
    ph = jnp.pad(img, ((0, 0), (r, r)), mode="edge")
    out = sum(float(k[j]) * ph[:, j:j + w] for j in range(ksize))
    pv = jnp.pad(out, ((r, r), (0, 0)), mode="edge")
    return sum(float(k[j]) * pv[j:j + h, :] for j in range(ksize))


def extract_patches(img, xy, patch_size: int):
    """Gather (N, P, P) patches centred on integer-rounded keypoints.

    Keypoints too close to the border must be pre-filtered by the
    detector; indices are clipped for safety.
    """
    h, w = img.shape
    r = patch_size // 2
    cx = jnp.round(xy[..., 0]).astype(jnp.int32)
    cy = jnp.round(xy[..., 1]).astype(jnp.int32)
    off = jnp.arange(-r, r + 1)
    yy = jnp.clip(cy[:, None, None] + off[None, :, None], 0, h - 1)
    xx = jnp.clip(cx[:, None, None] + off[None, None, :], 0, w - 1)
    return img[yy, xx]


def orientation(patches):
    """Intensity-centroid angle per patch (N,P,P) -> (N,) radians.

    The moment sum runs over the inscribed disk, matching ORB's circular
    support (IC_Angle), but GAUSSIAN-WEIGHTED toward the centre
    (sigma = r/2). An unweighted centroid over the full 33 px support is
    dominated by NEIGHBOURING image structure, and between two views of
    the same feature that context shifts with its own (different)
    parallax — measured on rectified synthetic stereo pairs: ~19 deg
    median L-R orientation disagreement, rotating the steered-BRIEF
    pattern enough to push true correspondences to a median Hamming
    distance of 84/256 bits (match-rate collapse). Centre weighting
    keeps the estimate anchored to the keypoint's own structure while
    preserving rotation covariance.
    """
    p = patches.shape[-1]
    r = p // 2
    off = jnp.arange(-r, r + 1, dtype=patches.dtype)
    oy = off[:, None]
    ox = off[None, :]
    r2 = oy * oy + ox * ox
    disk = r2 <= r * r
    sig = r / 2.0
    g = jnp.exp(-r2 / (2.0 * sig * sig))
    w = jnp.where(disk, patches * g, 0.0)
    m10 = jnp.sum(w * ox, axis=(-2, -1))
    m01 = jnp.sum(w * oy, axis=(-2, -1))
    return jnp.arctan2(m01, m10)


@functools.partial(jax.jit, static_argnames=("n_pairs",))
def _describe(patches, angles, pattern, n_pairs: int):
    """Steered rBRIEF bits from pre-extracted patches.

    The per-sample lookup patches[n, iy, ix] is expressed as two one-hot
    contractions instead of a scalar gather. Bit-identical up to matmul
    rounding (one nonzero term per row: exact in fp32; the DEFAULT
    precision used here is TF32 on the GPU, whose rounding of the
    sampled values flips a bit only where two samples are within it).
    """
    n, p, _ = patches.shape
    c = p // 2
    cos_t = jnp.cos(angles)[:, None]    # (N,1)
    sin_t = jnp.sin(angles)[:, None]
    # pattern: (B,2,2) -> rotate both sample points of every pair.
    px = pattern[None, :, :, 0]         # (1,B,2)
    py = pattern[None, :, :, 1]
    rx = cos_t[..., None] * px - sin_t[..., None] * py   # (N,B,2)
    ry = sin_t[..., None] * px + cos_t[..., None] * py
    ix = jnp.clip(jnp.round(rx).astype(jnp.int32) + c, 0, p - 1)
    iy = jnp.clip(jnp.round(ry).astype(jnp.int32) + c, 0, p - 1)
    s = n_pairs * 2
    iyf = iy.reshape(n, s)
    ixf = ix.reshape(n, s)
    rp = (iyf[..., None] == jnp.arange(p)).astype(patches.dtype)  # (N,S,P)
    cp = (ixf[..., None] == jnp.arange(p)).astype(patches.dtype)  # (N,S,P)
    prec = jax.lax.Precision.DEFAULT  # override global "highest" pin
    t = jnp.einsum("nsp,npq->nsq", rp, patches, precision=prec)   # (N,S,P)
    vals = jnp.einsum("nsq,nsq->ns", t, cp,
                      precision=prec).reshape(n, n_pairs, 2)
    bits = (vals[..., 0] < vals[..., 1]).astype(jnp.uint8)        # (N,B)
    # Pack 8 bits/byte, LSB-first.
    bits = bits.reshape(n, n_pairs // 8, 8)
    weights = (1 << jnp.arange(8, dtype=jnp.uint32)).astype(jnp.uint8)
    return jnp.sum(bits * weights[None, None, :], axis=-1,
                   dtype=jnp.uint8)                      # (N, n_pairs//8)


def describe(img_blurred, xy, angles, pattern):
    """Steered rBRIEF. img must already be blurred.

    Args:
      xy: (N,2) keypoint coords; angles: (N,); pattern: (B,2,2).
    Returns:
      (N, B//8) uint8 packed descriptors.
    """
    n_pairs = pattern.shape[0]
    patch = 2 * int(np.ceil(np.abs(np.asarray(pattern)).max() * 1.5)) + 3
    patch = max(patch, 33)
    patches = extract_patches(img_blurred, xy, patch)
    return _describe(patches, angles, jnp.asarray(pattern), n_pairs)


def unpack_bits_pm1(desc_packed):
    """(N, B/8) uint8 -> (N, B) int8 in {-1,+1} for matching as a
    matrix product."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (desc_packed[..., :, None] >> shifts[None, None, :]) & 1
    n = desc_packed.shape[0]
    bits = bits.reshape(n, -1).astype(jnp.int8)
    return bits * 2 - 1
