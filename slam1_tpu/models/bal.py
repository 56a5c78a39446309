"""BAL-style full bundle adjustment with 9-parameter cameras
(intrinsics refinement).

The reference keeps a classic BAL formulation dormant inside a string
literal (/root/reference/BundleAdjustment.py:230-466): per-camera
[rvec(3), tvec(3), f, k1, k2] plus 3D points, scipy least_squares over
reprojection residuals with a hand-built Jacobian sparsity mask. Here
it runs for real, batched on device: the same landmark-elimination Schur LM as
models/ba.py but with 9-dof camera blocks, so FOCAL LENGTH and RADIAL
DISTORTION are refined jointly with geometry.

Why this lives in its own module: the live SLAM backend (models/ba.py)
deliberately holds intrinsics FIXED — KITTI stereo is calibrated and
rectified, so f/k1/k2 are known a-priori, and letting them float only
adds a near-gauge direction (f trades off against depth and baseline
scale, destabilizing the stereo scale anchor). This solver is the
counterpart for BAL-format datasets (utils/export.load_bal), where
intrinsics are per-camera unknowns.

Camera model — the public BAL convention (Agarwal et al., "Bundle
Adjustment in the Large"; the reference's dormant `project`,
BundleAdjustment.py:317-331, implements the same):

    P  = R(rvec) @ X + t          world -> camera, axis-angle rotation
    p  = -(P.x, P.y) / P.z        NOTE the negation: BAL looks down -z
    uv = f * (1 + k1 |p|^2 + k2 |p|^4) * p
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from slam1_tpu.config import BAConfig
from slam1_tpu.ops import se3
from slam1_tpu.ops.cg import cg
from slam1_tpu.ops.lsq import huber_weights


class BalProblem(NamedTuple):
    cams: jnp.ndarray     # (C,9) [rvec(3), tvec(3), f, k1, k2]
    points: jnp.ndarray   # (L,3) world landmarks
    cam_idx: jnp.ndarray  # (O,) int32
    lm_idx: jnp.ndarray   # (O,) int32
    uv: jnp.ndarray       # (O,2) principal-point-centred observations
    w: jnp.ndarray        # (O,) observation weight; 0 = padding


def from_bal_dict(d) -> BalProblem:
    """Build a problem from utils.export.load_bal output."""
    import numpy as np
    return BalProblem(
        cams=jnp.asarray(np.asarray(d["cameras"], np.float32)),
        points=jnp.asarray(np.asarray(d["points"], np.float32)),
        cam_idx=jnp.asarray(d["cam_idx"], jnp.int32),
        lm_idx=jnp.asarray(d["lm_idx"], jnp.int32),
        uv=jnp.asarray(np.asarray(d["uv"], np.float32)),
        w=jnp.ones((len(d["cam_idx"]),), jnp.float32))


def project(cam9, X):
    """BAL projection of world point X (3,) through camera cam9 (9,)."""
    R = se3.exp_so3(cam9[:3])
    P = R @ X + cam9[3:6]
    p = -P[:2] / jnp.where(jnp.abs(P[2]) > 1e-9, P[2],
                           jnp.sign(P[2]) * 1e-9 + 1e-12)
    r2 = jnp.sum(p * p)
    f, k1, k2 = cam9[6], cam9[7], cam9[8]
    return f * (1.0 + k1 * r2 + k2 * r2 * r2) * p


def _residual(dcam, dl, cam9, X, uv):
    """2-vector reprojection residual under additive perturbation of the
    9 camera params and the landmark."""
    return project(cam9 + dcam, X + dl) - uv


def _cost(problem: BalProblem, huber_delta):
    cams = problem.cams[problem.cam_idx]
    X = problem.points[problem.lm_idx]
    o = problem.uv.shape[0]
    z9 = jnp.zeros((o, 9), problem.uv.dtype)
    z3 = jnp.zeros((o, 3), problem.uv.dtype)
    r = jax.vmap(_residual)(z9, z3, cams, X, problem.uv)
    r2 = jnp.sum(r * r, axis=-1)
    hw = huber_weights(r2, huber_delta)
    return jnp.sum(problem.w * hw * r2), r, hw


def _schur_solve9(problem, r, Jc, Jl, w, lam, cg_iters: int):
    """Damped GN step: eliminate landmarks (batched 3x3), solve the
    reduced camera system matrix-free with block-Jacobi PCG — identical
    structure to models/ba._schur_solve with 6-dof blocks widened to 9.
    No gauge pinning: LM damping keeps the normal equations SPD (the
    BAL gauge is a 7-dof similarity; pinning one camera would also have
    to pin a scale, damping handles both)."""
    C = problem.cams.shape[0]
    L = problem.points.shape[0]
    ci, li = problem.cam_idx, problem.lm_idx
    w2 = w[:, None, None]

    Hcc = jnp.zeros((C, 9, 9), r.dtype).at[ci].add(
        jnp.einsum("oai,oaj->oij", Jc, Jc) * w2)
    Hll = jnp.zeros((L, 3, 3), r.dtype).at[li].add(
        jnp.einsum("oai,oaj->oij", Jl, Jl) * w2)
    W = jnp.einsum("oai,oaj->oij", Jc, Jl) * w2                  # (O,9,3)
    bc = -jnp.zeros((C, 9), r.dtype).at[ci].add(
        jnp.einsum("oai,oa->oi", Jc, r * w[:, None]))
    bl = -jnp.zeros((L, 3), r.dtype).at[li].add(
        jnp.einsum("oai,oa->oi", Jl, r * w[:, None]))

    from slam1_tpu.models.ba import _diag_only, _inv3x3
    eye9 = jnp.eye(9, dtype=r.dtype)
    eye3 = jnp.eye(3, dtype=r.dtype)
    Hcc_d = Hcc + lam * _diag_only(Hcc) + 1e-6 * eye9
    Hll_d = Hll + lam * _diag_only(Hll) + 1e-6 * eye3
    Hll_inv = _inv3x3(Hll_d)

    btil = bc - jnp.zeros((C, 9), r.dtype).at[ci].add(
        jnp.einsum("oij,oj->oi", W,
                   jnp.einsum("lij,lj->li", Hll_inv, bl)[li]))

    def matvec(x):
        u = jnp.einsum("oij,oi->oj", W, x[ci])
        s = jnp.zeros((L, 3), r.dtype).at[li].add(u)
        v = jnp.einsum("lij,lj->li", Hll_inv, s)
        y = jnp.einsum("oij,oj->oi", W, v[li])
        out = jnp.einsum("cij,cj->ci", Hcc_d, x)
        return out - jnp.zeros((C, 9), r.dtype).at[ci].add(y)

    Minv = jnp.linalg.inv(Hcc_d)
    dc = cg(matvec, btil, iters=cg_iters,
            precond=lambda v: jnp.einsum("cij,cj->ci", Minv, v))

    u = jnp.einsum("oij,oi->oj", W, dc[ci])
    s = jnp.zeros((L, 3), r.dtype).at[li].add(u)
    dl = jnp.einsum("lij,lj->li", Hll_inv, bl - s)
    return dc, dl


@functools.partial(jax.jit, static_argnames=("cfg",))
def bal_adjust(problem: BalProblem,
               cfg: BAConfig) -> Tuple[BalProblem, jnp.ndarray]:
    """Full 9-param LM bundle adjustment (cameras incl. f/k1/k2 and
    points all free). Returns (optimized problem, final cost)."""
    cost0, _, _ = _cost(problem, cfg.huber_delta)

    # Param scales differ wildly (rvec ~1, f ~500): handled by
    # MULTIPLICATIVE damping (lam * diag(H), Marquardt scaling — scale
    # invariant) and the block-Jacobi CG preconditioner, not by column
    # normalization.
    def lm_step(carry, _):
        cams, points, lam, cost = carry
        p = problem._replace(cams=cams, points=points)
        _, r, hw = _cost(p, cfg.huber_delta)
        w = problem.w * hw
        camg = cams[p.cam_idx]
        X = points[p.lm_idx]
        o = p.uv.shape[0]
        z9 = jnp.zeros((o, 9), p.uv.dtype)
        z3 = jnp.zeros((o, 3), p.uv.dtype)
        r_ = jax.vmap(_residual)(z9, z3, camg, X, p.uv)
        Jc = jax.vmap(jax.jacfwd(_residual, argnums=0))(
            z9, z3, camg, X, p.uv)                              # (O,2,9)
        Jl = jax.vmap(jax.jacfwd(_residual, argnums=1))(
            z9, z3, camg, X, p.uv)                              # (O,2,3)
        dc, dl = _schur_solve9(p, r_, Jc, Jl, w, lam, cfg.cg_iters)
        dc = jnp.where(jnp.isfinite(dc), dc, 0.0)
        dl = jnp.where(jnp.isfinite(dl), dl, 0.0)
        new_cams = cams + dc
        new_points = points + dl
        new_cost, _, _ = _cost(
            problem._replace(cams=new_cams, points=new_points),
            cfg.huber_delta)
        accept = new_cost < cost
        cams = jnp.where(accept, new_cams, cams)
        points = jnp.where(accept, new_points, points)
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.clip(jnp.where(accept, lam / cfg.lm_lambda_down,
                                 lam * cfg.lm_lambda_up), 1e-9, 1e6)
        return (cams, points, lam, cost), cost

    (cams, points, _, cost), _ = jax.lax.scan(
        lm_step,
        (problem.cams, problem.points,
         jnp.asarray(cfg.lm_lambda0, problem.uv.dtype), cost0),
        None, length=cfg.lm_iters)
    return problem._replace(cams=cams, points=points), cost
