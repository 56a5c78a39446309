"""Fundamental-matrix estimation: vmapped 8-point RANSAC.

General-geometry counterpart of cv2.findFundamentalMat(FM_LMEDS)
(/root/reference/keypoint.py:59-66). The rectified stereo frontend uses
the trivial row/disparity gate instead (models/frontend.py); this module
serves non-rectified pairs and temporal-pair outlier rejection.

Shape: K hypotheses solved in one vmap (normalized 8-point via SVD
of the 8x9 design matrix + rank-2 projection), scored by Sampson
distance over all correspondences, best-by-inlier-count — the same
fixed-size RANSAC pattern as ops/pnp.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class FMatResult(NamedTuple):
    F: jnp.ndarray        # (3,3)
    inliers: jnp.ndarray  # (N,)
    num_inliers: jnp.ndarray
    ok: jnp.ndarray


def _normalize(uv, mask):
    """Hartley normalization: zero-mean, sqrt(2) RMS (masked)."""
    w = mask.astype(uv.dtype)[:, None]
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(uv * w, axis=0) / n
    d = jnp.sqrt(jnp.sum(jnp.sum((uv - mean) ** 2 * w, axis=-1)) / n)
    s = jnp.sqrt(2.0) / jnp.maximum(d, 1e-6)
    T = jnp.array([[s, 0, -s * mean[0]],
                   [0, s, -s * mean[1]],
                   [0, 0, 1.0]], uv.dtype)
    uvn = (uv - mean) * s
    return uvn, T


def _eight_point(uv1n, uv2n, T1, T2, w):
    """F from >=8 (weighted) normalized correspondences."""
    x1, y1 = uv1n[:, 0], uv1n[:, 1]
    x2, y2 = uv2n[:, 0], uv2n[:, 1]
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                   jnp.ones_like(x1)], axis=-1) * w[:, None]
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    F = Vt[8].reshape(3, 3)
    # rank-2 projection
    U, S, Vt2 = jnp.linalg.svd(F)
    F = (U * S.at[2].set(0.0)[None, :]) @ Vt2
    F = T2.T @ F @ T1
    return F / (F[2, 2] + jnp.where(jnp.abs(F[2, 2]) < 1e-12, 1e-12, 0.0))


def sampson_distance(F, uv1, uv2):
    """(N,) first-order geometric error of x2^T F x1 = 0."""
    ones = jnp.ones_like(uv1[:, :1])
    x1 = jnp.concatenate([uv1, ones], axis=-1)
    x2 = jnp.concatenate([uv2, ones], axis=-1)
    Fx1 = x1 @ F.T          # (N,3)
    Ftx2 = x2 @ F           # (N,3)
    num = jnp.sum(x2 * Fx1, axis=-1) ** 2
    den = Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2
    return num / jnp.maximum(den, 1e-12)


@functools.partial(jax.jit, static_argnames=("iters",))
def ransac_fundamental(key, uv1, uv2, mask, iters: int = 128,
                       px_thresh: float = 1.5,
                       min_inliers: int = 12) -> FMatResult:
    n = uv1.shape[0]
    uv1n, T1 = _normalize(uv1, mask)
    uv2n, T2 = _normalize(uv2, mask)

    gumbel = -jnp.log(-jnp.log(
        jax.random.uniform(key, (iters, n), minval=1e-9, maxval=1.0)))
    _, samples = jax.lax.top_k(jnp.where(mask[None, :], gumbel, -jnp.inf), 8)

    def solve_one(idx):
        return _eight_point(uv1n[idx], uv2n[idx], T1, T2,
                            mask[idx].astype(uv1.dtype))

    Fs = jax.vmap(solve_one)(samples)                          # (K,3,3)
    d = jax.vmap(lambda F: sampson_distance(F, uv1, uv2))(Fs)  # (K,N)
    t2 = px_thresh * px_thresh
    inl = (d < t2) & mask[None, :]
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)
    # Final polish: 8-point on all inliers of the best model.
    w = inl[best].astype(uv1.dtype)
    F = _eight_point(uv1n, uv2n, T1, T2, w)
    d_f = sampson_distance(F, uv1, uv2)
    inliers = (d_f < t2) & mask
    num = jnp.sum(inliers)
    use_polished = num >= counts[best]
    F = jnp.where(use_polished, F, Fs[best])
    inliers = jnp.where(use_polished, inliers, inl[best])
    num = jnp.maximum(num, counts[best])
    return FMatResult(F=F, inliers=inliers, num_inliers=num,
                      ok=num >= min_inliers)


# ---------------------------------------------------------------------------
# Essential-matrix 2D-2D pose (monocular bootstrap).
#
# The reference carries this path unused (get_pose/decomp_essential_mat,
# /root/reference/visual_odometry_solution_methods.py:50-68:
# cv2.findEssentialMat -> decomposeEssentialMat -> 4-candidate
# cheirality vote). Shape: E from the RANSAC F (E = K^T F K),
# closed-form SVD decomposition, and the cheirality vote as ONE batched
# triangulation over all 4 (R, t) candidates x all correspondences —
# no per-candidate Python loop.
# ---------------------------------------------------------------------------


class PoseFromE(NamedTuple):
    T: jnp.ndarray          # (4,4) camera2-from-camera1, |t| = 1
    inliers: jnp.ndarray    # (N,) epipolar inliers used for the vote
    num_inliers: jnp.ndarray
    ok: jnp.ndarray


def decompose_essential(E):
    """E -> (R1, R2, t) candidate factors (Hartley & Zisserman 9.6.2)."""
    U, _, Vt = jnp.linalg.svd(E)
    # Proper rotations: flip the sign of the singular vector blocks.
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                    E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return R1, R2, t


def _triangulate_pair(R, t, x1, x2):
    """Linear two-view triangulation in NORMALIZED coords (P1=[I|0],
    P2=[R|t]); returns (z1, z2) depths. Batched over correspondences."""
    # midpoint method: solve [x1, -R^T x2] [z1 z2]^T = R^T t  (3 eqs, 2 unk)
    a = x1                                   # (N,3)
    b = -(x2 @ R)                            # R^T x2 rows -> (N,3)
    rhs = -(t @ R)                           # R^T t        -> (3,)
    # normal equations per correspondence (2x2, closed form)
    aa = jnp.sum(a * a, -1)
    ab = jnp.sum(a * b, -1)
    bb = jnp.sum(b * b, -1)
    ar = a @ rhs
    br = b @ rhs
    det = aa * bb - ab * ab
    det = jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    z1 = (bb * ar - ab * br) / det
    z2 = (-ab * ar + aa * br) / det
    # depth in camera 2 of the camera-1 point: (R X1 + t).z
    X1 = x1 * z1[:, None]
    d2 = (X1 @ R.T + t)[:, 2]
    return z1, d2


@functools.partial(jax.jit, static_argnames=("iters",))
def recover_pose_2d2d(key, uv1, uv2, mask, K, iters: int = 256,
                      px_thresh: float = 1.5,
                      min_inliers: int = 12) -> PoseFromE:
    """Relative pose from 2D-2D correspondences (x2 ~ R x1 + t, |t|=1).

    RANSAC-F -> E = K^T F K -> 4-candidate decomposition -> batched
    cheirality vote (count of correspondences with positive depth in
    BOTH cameras, ref :58-64), restricted to epipolar inliers.
    """
    fres = ransac_fundamental(key, uv1, uv2, mask, iters=iters,
                              px_thresh=px_thresh,
                              min_inliers=min_inliers)
    E = K.T @ fres.F @ K
    # project to the essential manifold: singular values (1, 1, 0)
    U, _, Vt = jnp.linalg.svd(E)
    E = U @ jnp.diag(jnp.asarray([1.0, 1.0, 0.0], E.dtype)) @ Vt
    R1, R2, t = decompose_essential(E)

    Kinv = jnp.linalg.inv(K)
    ones = jnp.ones_like(uv1[:, :1])
    x1 = jnp.concatenate([uv1, ones], -1) @ Kinv.T
    x2 = jnp.concatenate([uv2, ones], -1) @ Kinv.T

    Rs = jnp.stack([R1, R1, R2, R2])                   # (4,3,3)
    ts = jnp.stack([t, -t, t, -t])                     # (4,3)
    z1, z2 = jax.vmap(_triangulate_pair, in_axes=(0, 0, None, None))(
        Rs, ts, x1, x2)                                # (4,N) each
    good = (z1 > 0) & (z2 > 0) & fres.inliers[None, :]
    votes = jnp.sum(good, axis=1)                      # (4,)
    best = jnp.argmax(votes)
    R_best, t_best = Rs[best], ts[best]
    T = jnp.eye(4, dtype=uv1.dtype)
    T = T.at[:3, :3].set(R_best).at[:3, 3].set(t_best)
    ok = fres.ok & (votes[best] >= min_inliers)
    return PoseFromE(T=T, inliers=fres.inliers,
                     num_inliers=fres.num_inliers, ok=ok)
