"""Brute-force Hamming descriptor matching as a ±1 contraction.

Replaces FLANN-LSH knn matching (/root/reference/keypoint.py:44,
tracking.py:12-34, Point3D.py:33-53). Descriptors unpacked to
{-1,+1}^256 int8 give

    dot(a, b) = B - 2 * hamming(a, b)

so the full N x M distance matrix is one int8 matrix product followed
by an affine rescale: at SLAM problem sizes (2k x 2k x 256) the
exhaustive product is cheaper than approximate hashing.

On a GPU the fused kernel in ops/pallas_kernels.py computes the top-2
without writing the distance matrix (ops/dispatch.py picks it); the
plain `jnp` path below is the reference and the CPU path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from slam1_tpu.ops.brief import unpack_bits_pm1
from slam1_tpu.ops.dispatch import use_kernels
from slam1_tpu.types import Matches

_BIG = jnp.int32(1 << 20)


def distance_matrix(desc_a, desc_b, mask_a=None, mask_b=None):
    """Packed uint8 descriptors -> (N,M) int32 Hamming distances.

    Invalid rows/columns get a large sentinel distance.
    """
    bits = desc_a.shape[-1] * 8
    a = unpack_bits_pm1(desc_a)
    b = unpack_bits_pm1(desc_b)
    sim = jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)          # (N,M)
    d = (bits - sim) // 2
    if mask_a is not None:
        d = jnp.where(mask_a[:, None], d, _BIG)
    if mask_b is not None:
        d = jnp.where(mask_b[None, :], d, _BIG)
    return d


def top2(desc_a, desc_b, mask_a=None, mask_b=None, *, uv_a=None,
         uv_b=None, dy_tol=None, dx_lo=0.0, dx_hi=0.0):
    """(d1, d2, best, col_best): each A row's best and second-best
    distance and argbest, and each B column's argmin row, over the
    candidates that pass the masks and the optional band gate
    (|y_b - y_a| <= dy_tol and dx_lo <= x_a - x_b <= dx_hi)."""
    if use_kernels():
        from slam1_tpu.ops.pallas_kernels import hamming_top2
        n, m = desc_a.shape[0], desc_b.shape[0]
        ma = jnp.ones((n,), bool) if mask_a is None else mask_a
        mb = jnp.ones((m,), bool) if mask_b is None else mask_b
        gate = {} if dy_tol is None else dict(
            uv_a=uv_a, uv_b=uv_b, dy_tol=float(dy_tol),
            dx_lo=float(dx_lo), dx_hi=float(dx_hi))
        return hamming_top2(unpack_bits_pm1(desc_a), unpack_bits_pm1(desc_b),
                            ma, mb, **gate)
    return top2_plain(gated_distances(desc_a, desc_b, mask_a, mask_b,
                                      uv_a=uv_a, uv_b=uv_b, dy_tol=dy_tol,
                                      dx_lo=dx_lo, dx_hi=dx_hi))


def gated_distances(desc_a, desc_b, mask_a=None, mask_b=None, *,
                    uv_a=None, uv_b=None, dy_tol=None, dx_lo=0.0,
                    dx_hi=0.0):
    """distance_matrix with the band gate of `top2` applied."""
    d = distance_matrix(desc_a, desc_b, mask_a, mask_b)
    if dy_tol is None:
        return d
    dy = jnp.abs(uv_a[:, 1:2] - uv_b[None, :, 1])
    dx = uv_a[:, 0:1] - uv_b[None, :, 0]
    return jnp.where((dy > dy_tol) | (dx < dx_lo) | (dx > dx_hi), _BIG, d)


def top2_plain(d):
    """`top2` of a materialized (N,M) distance matrix: the reference."""
    # Two smallest distances per row == two largest of -d.
    neg_top2, idx_top2 = jax.lax.top_k(-d, 2)
    return (-neg_top2[:, 0], -neg_top2[:, 1], idx_top2[:, 0],
            jnp.argmin(d, axis=0))


def accept(d1, d2, best, col_best, mask_a, *, ratio, max_distance,
           cross_check) -> Matches:
    """Absolute distance gate, Lowe ratio test and optional mutual
    consistency on a top-2 result."""
    ok = (d1 <= max_distance) & (d1.astype(jnp.float32)
                                 < ratio * d2.astype(jnp.float32))
    if cross_check:
        ok = ok & (col_best[best] == jnp.arange(d1.shape[0]))
    if mask_a is not None:
        ok = ok & mask_a
    return Matches(idx=best, distance=d1, mask=ok)


def match(desc_a, desc_b, mask_a=None, mask_b=None, *, ratio=0.8,
          max_distance=64, cross_check=True) -> Matches:
    """Best-match with Lowe ratio test and optional mutual consistency.

    Mirrors the reference's knn(k=2) + 0.7-ratio filter
    (keypoint.py:44-51) plus an absolute distance gate.
    """
    return accept(*top2(desc_a, desc_b, mask_a, mask_b), mask_a,
                  ratio=ratio, max_distance=max_distance,
                  cross_check=cross_check)


def match_epipolar(desc_a, desc_b, xy_a, xy_b, mask_a, mask_b, *,
                   ratio=0.8, max_distance=64, dy_tol=2.0,
                   min_disparity=0.25, max_disparity=96.0,
                   cross_check=True) -> Matches:
    """Rectified-stereo matching: the epipolar band (|dy| <= dy_tol,
    disparity in [min, max]) is applied to the distance matrix BEFORE
    best/second-best selection.

    Gating candidates first changes what the Lowe ratio test measures:
    the second-best then comes from the ~10 candidates geometrically
    able to correspond, not from the whole frame — on self-similar
    imagery the global second-best is routinely a lookalike elsewhere
    in the image and the ratio test throws away the majority of true
    stereo pairs (measured: 133 within-distance-gate matches reduced to
    56 by the global ratio test on a 192-feature frame). This is the
    brute-force analogue of classical scanline stereo matching; the
    reference's FLANN+LMedS pipeline (keypoint.py:35-66) filters AFTER
    matching and pays the same recall cost.
    """
    return accept(*top2(desc_a, desc_b, mask_a, mask_b, uv_a=xy_a,
                        uv_b=xy_b, dy_tol=dy_tol, dx_lo=min_disparity,
                        dx_hi=max_disparity), mask_a,
                  ratio=ratio, max_distance=max_distance,
                  cross_check=cross_check)


def match_windowed(desc_a, desc_b, uv_pred_a, xy_b, mask_a, mask_b, *,
                   radius, ratio=0.8, max_distance=64,
                   cross_check=True) -> Matches:
    """Prediction-gated matching: B candidates outside a `radius`-px
    window around each A row's PREDICTED position are masked out of the
    distance matrix before best/second-best selection — the temporal
    analogue of match_epipolar's band (the ratio test then compares
    against candidates the motion model considers reachable, not the
    whole frame's lookalikes). The gate is an axis-aligned square, the
    band form with dx in [-radius, radius]."""
    return accept(*top2(desc_a, desc_b, mask_a, mask_b, uv_a=uv_pred_a,
                        uv_b=xy_b, dy_tol=radius, dx_lo=-radius,
                        dx_hi=radius), mask_a,
                  ratio=ratio, max_distance=max_distance,
                  cross_check=cross_check)


def gather_matches(values_b, matches: Matches, fill=0.0):
    """Gather per-match rows of `values_b` aligned to A's index space."""
    out = values_b[matches.idx]
    return jnp.where(
        matches.mask.reshape((-1,) + (1,) * (out.ndim - 1)), out, fill)
