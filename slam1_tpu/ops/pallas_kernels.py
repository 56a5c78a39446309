"""Fused Hamming top-2 matcher: a Pallas kernel for the GPU, Triton route.

One program owns a block of `_BN` descriptor rows of A and walks every
`_BM`-column tile of B inside the block. Each tile's (BN, BM) distance
matrix comes from one int8 tensor-core product (descriptors unpacked to
{-1,+1}: dot = bits - 2 * hamming, exact in int32), is gated in
registers (validity masks and the optional epipolar band or prediction
window), and is folded into the row's running (best, second, argbest).
The column-wise argmin that the cross-check needs cannot be carried
across programs, which run in parallel and in no order: each tile
contributes its column minima through `atomic_min` on a packed int32
key, the distance (clamped to 9 bits) above the row index, so the
smallest distance wins and ties go to the lowest row as in
`jnp.argmin`. Nothing N x M reaches device memory, and the plain
path's sort-based `lax.top_k` over an (N, M) int32 matrix is gone.

`ops/hamming.py` holds the plain reference and picks the kernel on the
GPU (`ops/dispatch.py`); the `interpret` flag runs it on the CPU for
tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_BIG = 1 << 20            # distance of a masked or gated pair
_INT_MAX = 0x7FFFFFFF
_ROW_BITS = 22            # packed column key: (min(d, 511) << 22) | row
# A rows per program: 16 is the least a tensor-core product takes, and
# at N = 2688 it gives 168 programs for the H100's 132 SMs.
_BN = 16
_BM = 128                 # B columns per tile of the inner loop (<= 256:
                          # a column index fits in the key's low 8 bits)


def _hamming_kernel(bits, gate, a_ref, b_ref, ma_ref, mb_ref, xa_ref,
                    ya_ref, xb_ref, yb_ref, _ckey_in, d1_ref, d2_ref,
                    idx_ref, ckey_ref):
    bn = a_ref.shape[0]
    n_tiles = b_ref.shape[0] // _BM
    row0 = pl.program_id(0) * bn
    a = a_ref[...]
    row_ok = ma_ref[...] != 0
    rows = row0 + jax.lax.broadcasted_iota(jnp.int32, (bn, _BM), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (bn, _BM), 1)
    if gate is not None:
        dy_tol, dx_lo, dx_hi = gate
        xa = xa_ref[...][:, None]
        ya = ya_ref[...][:, None]

    def tile(j, carry):
        d1, d2, idx = carry
        cs = pl.ds(pl.multiple_of(j * _BM, _BM), _BM)
        sim = pl.dot(a, b_ref[cs, :], trans_b=True,
                     precision=jax.lax.Precision.DEFAULT)   # int32 (BN,BM)
        d = (bits - sim) >> 1
        ok = row_ok[:, None] & (mb_ref[cs] != 0)[None, :]
        if gate is not None:
            dx = xa - xb_ref[cs][None, :]
            ok = ok & (jnp.abs(yb_ref[cs][None, :] - ya) <= dy_tol) \
                & (dx >= dx_lo) & (dx <= dx_hi)
        d = jnp.where(ok, d, _BIG)

        # Row top-2 of the tile from two plain min-reductions of a packed
        # (distance << 8) | column key: the lowest column wins a tie, as
        # in lax.top_k, and a tied second entry gives d2 == d1.
        rk = (d << 8) | cols
        k1 = jnp.min(rk, axis=1)
        k2 = jnp.min(jnp.where(rk == k1[:, None], _INT_MAX, rk), axis=1)
        t1, ti, t2 = k1 >> 8, k1 & 255, k2 >> 8
        better = t1 < d1                  # strict: earlier tiles win ties
        d2 = jnp.where(better, jnp.minimum(d1, t2), jnp.minimum(d2, t1))
        d1 = jnp.where(better, t1, d1)
        idx = jnp.where(better, ti + j * _BM, idx)

        key = (jnp.minimum(d, 511) << _ROW_BITS) | rows
        plgpu.atomic_min(ckey_ref, cs, jnp.min(key, axis=0))
        return d1, d2, idx

    big = jnp.full((bn,), _BIG, jnp.int32)
    d1, d2, idx = jax.lax.fori_loop(
        0, n_tiles, tile, (big, big, jnp.zeros((bn,), jnp.int32)))
    d1_ref[...] = d1
    d2_ref[...] = d2
    idx_ref[...] = idx


@functools.partial(jax.jit, static_argnames=("dy_tol", "dx_lo", "dx_hi",
                                             "interpret"))
def hamming_top2(a_pm1, b_pm1, mask_a, mask_b, *, uv_a=None, uv_b=None,
                 dy_tol=None, dx_lo=0.0, dx_hi=0.0,
                 interpret: bool = False):
    """Fused Hamming top-2 of every A row over B, with an optional gate.

    Args:
      a_pm1: (N, bits) int8 descriptors unpacked to {-1,+1}; any N.
      b_pm1: (M, bits) int8; any M.
      mask_a, mask_b: (N,), (M,) bool; invalid rows and columns get the
        sentinel distance 2^20.
      uv_a, uv_b: optional (N,2), (M,2) float pixel coordinates. Column
        b is eligible for row a only if |y_b - y_a| <= dy_tol and
        dx_lo <= x_a - x_b <= dx_hi: the epipolar band with uv_a = A's
        positions, a prediction window with uv_a = predicted positions
        and dx_lo = -dx_hi = -radius. dy_tol, dx_lo, dx_hi are static.
    Returns:
      d1, d2, idx: (N,) int32 best and second-best distance and argbest
        per row; col_best: (M,) int32 argmin row of each column, under
        the same masks and gate (for the cross-check).
    """
    n, bits = a_pm1.shape
    m = b_pm1.shape[0]
    assert (uv_a is None) == (dy_tol is None)
    bn = _BN
    n_pad = -(-n // bn) * bn
    m_pad = -(-m // _BM) * _BM

    def pad(x, size, value=0):
        return jnp.pad(x, [(0, size - x.shape[0])] + [(0, 0)] * (x.ndim - 1),
                       constant_values=value)

    a = pad(a_pm1.astype(jnp.int8), n_pad)
    b = pad(b_pm1.astype(jnp.int8), m_pad)
    ma = pad(mask_a.astype(jnp.int32), n_pad)     # pad rows and columns
    mb = pad(mask_b.astype(jnp.int32), m_pad)     # are masked out
    if uv_a is None:
        xa = ya = jnp.zeros((n_pad,), jnp.float32)
        xb = yb = jnp.zeros((m_pad,), jnp.float32)
        gate = None
    else:
        xa = pad(uv_a[:, 0].astype(jnp.float32), n_pad)
        ya = pad(uv_a[:, 1].astype(jnp.float32), n_pad)
        xb = pad(uv_b[:, 0].astype(jnp.float32), m_pad)
        yb = pad(uv_b[:, 1].astype(jnp.float32), m_pad)
        gate = (float(dy_tol), float(dx_lo), float(dx_hi))
    ckey0 = jnp.full((m_pad,), _INT_MAX, jnp.int32)

    rows = pl.BlockSpec((bn,), lambda i: (i,))
    whole_b = pl.BlockSpec((m_pad,), lambda i: (0,))
    d1, d2, idx, ckey = pl.pallas_call(
        functools.partial(_hamming_kernel, bits, gate),
        grid=(n_pad // bn,),
        in_specs=[pl.BlockSpec((bn, bits), lambda i: (i, 0)),
                  pl.BlockSpec((m_pad, bits), lambda i: (0, 0)),
                  rows, whole_b, rows, rows, whole_b, whole_b, whole_b],
        out_specs=[rows, rows, rows, whole_b],
        out_shape=[jax.ShapeDtypeStruct((n_pad,), jnp.int32)] * 3
        + [jax.ShapeDtypeStruct((m_pad,), jnp.int32)],
        input_output_aliases={8: 3},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="hamming_top2",
    )(a, b, ma, mb, xa, ya, xb, yb, ckey0)
    col_best = ckey[:m] & ((1 << _ROW_BITS) - 1)
    return d1[:n], d2[:n], idx[:n], col_best
