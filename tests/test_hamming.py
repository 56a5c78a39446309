import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam1_tpu.ops import hamming


def rand_desc(rng, n):
    return rng.integers(0, 256, (n, 32), dtype=np.uint8)


def np_hamming(a, b):
    ab = np.unpackbits(a[:, None, :], axis=-1)
    bb = np.unpackbits(b[None, :, :], axis=-1)
    return (ab != bb).sum(-1)


def test_distance_matrix_matches_numpy():
    rng = np.random.default_rng(0)
    a, b = rand_desc(rng, 17), rand_desc(rng, 23)
    d = np.asarray(hamming.distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(d, np_hamming(a, b))


def test_distance_zero_on_self():
    rng = np.random.default_rng(1)
    a = rand_desc(rng, 8)
    d = np.asarray(hamming.distance_matrix(jnp.asarray(a), jnp.asarray(a)))
    np.testing.assert_array_equal(np.diag(d), 0)


def test_masked_rows_never_match():
    rng = np.random.default_rng(2)
    a = rand_desc(rng, 8)
    mask = np.ones(8, bool)
    mask[3] = False
    m = hamming.match(jnp.asarray(a), jnp.asarray(a),
                      jnp.asarray(mask), jnp.asarray(mask),
                      ratio=1.1, max_distance=256, cross_check=False)
    got = np.asarray(m.mask)
    assert not got[3]
    assert got[[0, 1, 2, 4, 5, 6, 7]].all()
    np.testing.assert_array_equal(
        np.asarray(m.idx)[got], np.arange(8)[got])


def test_ratio_test_rejects_ambiguous():
    # two identical descriptors in B -> d1 == d2 -> ratio test fails
    rng = np.random.default_rng(3)
    a = rand_desc(rng, 4)
    b = np.concatenate([a[:1], a[:1], a[1:]])  # duplicate of a[0]
    m = hamming.match(jnp.asarray(a), jnp.asarray(b), ratio=0.8,
                      cross_check=False)
    assert not bool(m.mask[0])   # ambiguous
    assert bool(m.mask[1])


def test_cross_check():
    a = np.zeros((2, 32), np.uint8)
    a[1, 0] = 255                      # a0=0s, a1 differs by 8 bits
    b = np.zeros((3, 32), np.uint8)    # b0 == a0, b1 garbage, b2 far
    b[1, :16] = 170
    b[2] = 255
    m = hamming.match(jnp.asarray(a), jnp.asarray(b), ratio=0.95,
                      max_distance=256, cross_check=True)
    assert bool(m.mask[0]) and int(m.idx[0]) == 0


def test_match_is_jittable():
    rng = np.random.default_rng(4)
    a = jnp.asarray(rand_desc(rng, 64))
    f = jax.jit(lambda x, y: hamming.match(x, y))
    m = f(a, a)
    assert bool(np.asarray(m.mask).all())


# The three matchers as they were written before their ratio-test and
# cross-check tails were merged into hamming.accept: the reference for
# the merged helper on both paths (plain jnp, and the kernel in
# interpret mode).
def _old_match(da, db, ma, mb, ratio, max_distance):
    d = hamming.distance_matrix(da, db, ma, mb)
    return _old_tail(d, ma, ratio, max_distance)


def _old_match_epipolar(da, db, xa, xb, ma, mb, ratio, max_distance,
                        dy_tol, lo, hi):
    d = hamming.distance_matrix(da, db, ma, mb)
    dy = jnp.abs(xa[:, 1:2] - xb[None, :, 1])
    disp = xa[:, 0:1] - xb[None, :, 0]
    d = jnp.where((dy > dy_tol) | (disp < lo) | (disp > hi), 1 << 20, d)
    return _old_tail(d, ma, ratio, max_distance)


def _old_match_windowed(da, db, ua, xb, ma, mb, ratio, max_distance,
                        radius):
    d = hamming.distance_matrix(da, db, ma, mb)
    dy = jnp.abs(ua[:, 1:2] - xb[None, :, 1])
    dx = ua[:, 0:1] - xb[None, :, 0]
    d = jnp.where((dy > radius) | (jnp.abs(dx) > radius), 1 << 20, d)
    return _old_tail(d, ma, ratio, max_distance)


def _old_tail(d, mask_a, ratio, max_distance):
    neg_top2, idx_top2 = jax.lax.top_k(-d, 2)
    d1, d2 = -neg_top2[:, 0], -neg_top2[:, 1]
    best = idx_top2[:, 0]
    ok = (d1 <= max_distance) & (d1.astype(jnp.float32)
                                 < ratio * d2.astype(jnp.float32))
    col_best = jnp.argmin(d, axis=0)
    ok = ok & (col_best[best] == jnp.arange(d.shape[0]))
    return best, d1, ok & mask_a


@pytest.mark.parametrize("path", ["plain", "kernel"])
@pytest.mark.parametrize("form", ["match", "epipolar", "windowed"])
def test_merged_tail_matches_old_call_sites(monkeypatch, form, path):
    if path == "kernel":
        import functools

        from slam1_tpu.ops import pallas_kernels
        monkeypatch.setattr(hamming, "use_kernels", lambda: True)
        monkeypatch.setattr(pallas_kernels, "hamming_top2", functools.partial(
            pallas_kernels.hamming_top2, interpret=True))
    rng = np.random.default_rng(11)
    n, m = 150, 140
    # Near-duplicate descriptors so the gates and the ratio test matter.
    base = rand_desc(rng, m)
    flip = rng.random((n, 32)) < 0.02
    da = jnp.asarray(base[rng.integers(0, m, n)]
                     ^ (flip * rng.integers(0, 256, (n, 32))).astype(np.uint8))
    db = jnp.asarray(base)
    ma = jnp.asarray(rng.random(n) > 0.1)
    mb = jnp.asarray(rng.random(m) > 0.1)
    xa = jnp.asarray(rng.uniform(0, 200, (n, 2)).astype(np.float32))
    xb = jnp.asarray(rng.uniform(0, 200, (m, 2)).astype(np.float32))
    kw = dict(ratio=0.8, max_distance=64)
    if form == "match":
        got = hamming.match(da, db, ma, mb, **kw)
        ref = _old_match(da, db, ma, mb, **kw)
    elif form == "epipolar":
        got = hamming.match_epipolar(da, db, xa, xb, ma, mb, dy_tol=40.0,
                                     min_disparity=-50.0,
                                     max_disparity=80.0, **kw)
        ref = _old_match_epipolar(da, db, xa, xb, ma, mb, dy_tol=40.0,
                                  lo=-50.0, hi=80.0, **kw)
    else:
        got = hamming.match_windowed(da, db, xa, xb, ma, mb, radius=60.0,
                                     **kw)
        ref = _old_match_windowed(da, db, xa, xb, ma, mb, radius=60.0,
                                  **kw)
    best, d1, ok = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(np.asarray(got.mask), ok)
    np.testing.assert_array_equal(np.asarray(got.distance), d1)
    np.testing.assert_array_equal(np.asarray(got.idx)[ok], best[ok])
    assert ok.sum() > 10
