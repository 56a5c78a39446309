"""The fused Hamming kernel against its jnp reference.

The CPU cases run the kernel in Pallas interpret mode; the `gpu` cases
run it as compiled for the card and skip elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam1_tpu.ops import hamming
from slam1_tpu.ops.brief import unpack_bits_pm1
from slam1_tpu.ops.pallas_kernels import hamming_top2

_GATE = dict(dy_tol=10.0, dx_lo=0.5, dx_hi=40.0)


def _check_against_dense(n, m, gated, interpret, seed=0):
    rng = np.random.default_rng(seed)
    da = jnp.asarray(rng.integers(0, 256, (n, 32), dtype=np.uint8))
    db = jnp.asarray(rng.integers(0, 256, (m, 32), dtype=np.uint8))
    ma = jnp.asarray(rng.random(n) > 0.2)
    mb = jnp.asarray(rng.random(m) > 0.2)
    d = np.asarray(hamming.distance_matrix(da, db, ma, mb)).astype(float)
    kw = {}
    if gated:
        uva = rng.uniform(0, 100, (n, 2)).astype(np.float32)
        uvb = rng.uniform(0, 100, (m, 2)).astype(np.float32)
        kw = dict(uv_a=jnp.asarray(uva), uv_b=jnp.asarray(uvb), **_GATE)
        dy = np.abs(uva[:, 1:2] - uvb[None, :, 1])
        dx = uva[:, 0:1] - uvb[None, :, 0]
        d[(dy > _GATE["dy_tol"]) | (dx < _GATE["dx_lo"])
          | (dx > _GATE["dx_hi"])] = 1 << 20

    d1, d2, idx, col_best = hamming_top2(
        unpack_bits_pm1(da), unpack_bits_pm1(db), ma, mb,
        interpret=interpret, **kw)

    order = np.sort(d, axis=1)
    np.testing.assert_array_equal(np.asarray(d1), order[:, 0])
    np.testing.assert_array_equal(np.asarray(d2), order[:, 1])
    # argbest may differ on exact ties; distances at the index must agree.
    np.testing.assert_array_equal(
        d[np.arange(n), np.asarray(idx)], np.asarray(d1))
    np.testing.assert_array_equal(
        d[np.asarray(col_best), np.arange(m)], d.min(axis=0))


@pytest.mark.parametrize("n,m", [(256, 128), (200, 136)])
def test_hamming_top2_matches_dense(n, m):
    _check_against_dense(n, m, gated=False, interpret=True)


@pytest.mark.parametrize("n,m", [(256, 128), (200, 136)])
def test_hamming_top2_gated_matches_dense(n, m):
    """The fused geometric gate must agree with masking the dense
    distance matrix (epipolar-band form); 200x136 is no block multiple,
    so the wrapper's padding is masked out."""
    _check_against_dense(n, m, gated=True, interpret=True, seed=4)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,gated", [(2688, 2688, True),
                                       (2688, 2688, False),
                                       (1024, 1024, False),
                                       (200, 136, True)])
def test_hamming_top2_on_card(gpu, n, m, gated):
    _check_against_dense(n, m, gated=gated, interpret=False, seed=n + m)


@pytest.mark.gpu
def test_matcher_takes_kernel_on_card(gpu):
    """On the card every shape goes to the kernel (no block-multiple
    condition), and the matches equal the plain path's."""
    rng = np.random.default_rng(3)
    da = jnp.asarray(rng.integers(0, 256, (300, 32), dtype=np.uint8))
    db = jnp.asarray(rng.integers(0, 256, (170, 32), dtype=np.uint8))
    text = jax.jit(hamming.match).lower(da, db).as_text()
    assert "hamming_top2" in text
    got = hamming.match(da, db)
    ref = hamming.accept(*hamming.top2_plain(hamming.distance_matrix(
        da, db)), None, ratio=0.8, max_distance=64, cross_check=True)
    np.testing.assert_array_equal(np.asarray(got.mask),
                                  np.asarray(ref.mask))
    np.testing.assert_array_equal(np.asarray(got.distance),
                                  np.asarray(ref.distance))
