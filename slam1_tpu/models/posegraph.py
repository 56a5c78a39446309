"""Pose-graph optimization with loop-closure constraints.

The real version of what the reference approximates twice:

  - its "active backend" pose-only BA with motion priors and a
    loop-endpoint constraint (/root/reference/BundleAdjustment.py:107-183)
  - its translation-only linear error smear after a loop closure
    (loop_closure.py:39-52) — the degenerate special case of one GN
    step on a chain graph.

Design: all edges evaluated in one vmap (residual = SE(3) log of
the cycle error, Jacobians by jacfwd at the identity perturbation), the
Gauss-Newton normal equations solved matrix-free with CG where each
matvec is gather -> per-edge 6x6 block products -> segment-sum. Static
shapes: edge arrays are fixed capacity with weight masks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam1_tpu.config import BAConfig
from slam1_tpu.ops import se3
from slam1_tpu.ops.cg import cg


class PoseGraph(NamedTuple):
    poses: jnp.ndarray    # (F,4,4) T_world_frame
    ei: jnp.ndarray       # (E,) int32 edge source
    ej: jnp.ndarray       # (E,) int32 edge target
    z: jnp.ndarray        # (E,4,4) measured T_i_j = inv(T_i) @ T_j
    w: jnp.ndarray        # (E,) float32 edge weight (0 = disabled)


def odometry_edges(poses, rel_twists, mask):
    """Chain edges from per-frame relative twists (i -> i+1)."""
    f = poses.shape[0]
    ei = jnp.arange(f - 1, dtype=jnp.int32)
    ej = ei + 1
    z = se3.exp_se3(rel_twists)
    return ei, ej, z, mask.astype(jnp.float32)


def _edge_residual(delta_i, delta_j, T_i, T_j, Z):
    Ti = T_i @ se3.exp_se3(delta_i)
    Tj = T_j @ se3.exp_se3(delta_j)
    return se3.log_se3(se3.inverse(Z) @ (se3.inverse(Ti) @ Tj))


def _inv6(M):
    """Batched closed-form general 6x6 inverse via 3x3 block Schur
    (all adjugate 3x3 inverses, no batched LU). Assumes the
    upper-left 3x3 block is invertible, which holds for the chain-edge
    Jacobians used here (J = I + O(residual))."""
    from slam1_tpu.ops.lsq import inv3x3
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    C = M[..., 3:, :3]
    D = M[..., 3:, 3:]
    Ai = inv3x3(A)
    S = D - C @ Ai @ B
    Si = inv3x3(S)
    AiB = Ai @ B
    CAi = C @ Ai
    top = jnp.concatenate([Ai + AiB @ Si @ CAi, -AiB @ Si], axis=-1)
    bot = jnp.concatenate([-Si @ CAi, Si], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _chain_sqrt_solve(JjInv, Ji, winv, v):
    """Apply the square-root chain preconditioner M^-1 v where
    M = A^T W A is the odometry-chain part of the GN normal matrix in
    FACTORED form: A is the block-bidiagonal edge Jacobian (row i =
    chain edge (i-1, i) with diagonal block Jj_i and sub-diagonal
    block Ji_i; pose 0's column is dropped by the gauge), W the edge
    weights. M^-1 = A^-1 W^-1 A^-T is two bidiagonal sweeps around an
    elementwise scale.

    Solving through the FACTOR instead of the assembled tridiagonal
    normal matrix is the standard square-root trick: substitution
    growth is bounded by the norm of the composed chain adjoint
    (~scene diameter), where the block-LDL^T of the normal matrix
    amplifies by sqrt(cond(M)) and overflows f32 on a 2000-pose chain
    with 1e-4 damping (measured: inf by step 438).

    Arrays are pose-indexed: row i in [1, F) holds chain edge
    (i-1, i); row 0 is unused (gauge-pinned pose 0, x_0 = 0)."""
    f = v.shape[0]
    JjInvT = jnp.swapaxes(JjInv, -1, -2)
    JiT = jnp.swapaxes(Ji, -1, -2)

    # s = A^-T v: backward sweep, s_i = Jj_i^-T (v_i - Ji_{i+1}^T s_{i+1})
    JiT_next = jnp.concatenate([JiT[2:], jnp.zeros((1, 6, 6), v.dtype)])

    def bwd(s_next, xs):
        JjT_i, JiT_n, v_i = xs
        s_i = JjT_i @ (v_i - JiT_n @ s_next)
        return s_i, s_i

    # Derive the zero carries FROM v (v[0] * 0) rather than zeros():
    # inside shard_map a fresh constant is unvarying over the manual
    # axis while the scan outputs are varying, and the carry types
    # must match (jax 0.9 vma check).
    zero6 = v[0] * 0.0
    _, s = jax.lax.scan(bwd, zero6,
                        (JjInvT[1:], JiT_next, v[1:]), reverse=True)

    u = winv[1:, None] * s

    # x = A^-1 u: forward sweep, x_i = Jj_i^-1 (u_i - Ji_i x_{i-1})
    def fwd(x_prev, xs):
        JjI_i, Ji_i, u_i = xs
        x_i = JjI_i @ (u_i - Ji_i @ x_prev)
        return x_i, x_i

    _, x = jax.lax.scan(fwd, zero6, (JjInv[1:], Ji[1:], u))
    return jnp.concatenate([zero6[None], x])


@functools.partial(jax.jit, static_argnames=("iters", "cg_iters",
                                             "chain_precond"))
def optimize(graph: PoseGraph, iters: int = 10, cg_iters: int = 50,
             damping: float = 1e-4, chain_precond: bool = True):
    """Gauss-Newton pose-graph relaxation. Pose 0 is gauge-fixed.

    chain_precond=True preconditions each GN step's CG with the exact
    inverse of the odometry-chain part of the normal matrix, applied in
    SQUARE-ROOT form: M = A^T W A with A the block-bidiagonal chain
    Jacobian, so M^-1 v = A^-1 W^-1 A^-T v is two bidiagonal sweeps
    (lax.scans) around an elementwise scale (_chain_sqrt_solve). A SLAM
    pose graph is that chain plus K loop edges, so the preconditioned
    system is identity + rank-12K — CG then converges in ~O(K)
    iterations INDEPENDENT of trajectory length, where unpreconditioned
    CG needs O(F) iterations to propagate a loop correction along the
    chain (measured at 2000 frames / 3 loop edges: keyframe ATE stuck
    at 24.7 m with cg=64, still 21 m after cumulative 100 GN x ~1024
    CG). The per-edge 6x6 inverses are batched closed-form; only the
    two sweeps are sequential.

    Returns (optimized poses (F,4,4), final weighted cost ()).
    """
    f = graph.poses.shape[0]

    def gn_step(poses, _):
        T_i = poses[graph.ei]
        T_j = poses[graph.ej]
        zero = jnp.zeros((graph.ei.shape[0], 6), poses.dtype)

        r0 = jax.vmap(_edge_residual)(zero, zero, T_i, T_j, graph.z)  # (E,6)
        Ji = jax.vmap(jax.jacfwd(_edge_residual, argnums=0))(
            zero, zero, T_i, T_j, graph.z)                            # (E,6,6)
        Jj = jax.vmap(jax.jacfwd(_edge_residual, argnums=1))(
            zero, zero, T_i, T_j, graph.z)
        # Hard-mask disabled edges BEFORE weighting: a w=0 edge between
        # a live pose and an identity padding row can sit at a log-map
        # singularity (relative rotation ~ pi), where the residual and
        # Jacobians are NaN — and 0 * NaN = NaN poisons the whole solve
        # (observed live at 2000-frame scale; dist_pgo has carried the
        # same guard since r3).
        evalid = (graph.w > 0)[:, None]
        r0 = jnp.where(evalid, r0, 0.0)
        Ji = jnp.where(evalid[..., None], Ji, 0.0)
        Jj = jnp.where(evalid[..., None], Jj, 0.0)

        w = graph.w[:, None]

        def scatter(vals_i, vals_j):
            out = jnp.zeros((f, 6), poses.dtype)
            out = out.at[graph.ei].add(vals_i)
            out = out.at[graph.ej].add(vals_j)
            return out

        b = -scatter(jnp.einsum("eab,ea->eb", Ji, r0 * w),
                     jnp.einsum("eab,ea->eb", Jj, r0 * w))

        def matvec(x):
            xi = x[graph.ei]
            xj = x[graph.ej]
            y = (jnp.einsum("eab,eb->ea", Ji, xi)
                 + jnp.einsum("eab,eb->ea", Jj, xj)) * w     # (E,6)
            out = scatter(jnp.einsum("eab,ea->eb", Ji, y),
                          jnp.einsum("eab,ea->eb", Jj, y))
            out = out + damping * x
            return out.at[0].set(x[0])       # gauge: pin pose 0

        b = b.at[0].set(0.0)
        precond = None
        if chain_precond:
            # Gather the consecutive-pose edges into pose-indexed rows
            # (row ej holds chain edge (ej-1, ej)); non-chain rows get
            # the identity edge (Ji=0, Jj=I, w=0 -> winv=1/damping),
            # which matches the damping-only rows of H there.
            eye = jnp.eye(6, dtype=poses.dtype)
            is_chain = (graph.ej == graph.ei + 1) & (graph.w > 0)
            rows = jnp.where(is_chain, graph.ej, f)       # OOB -> drop
            JiC = jnp.zeros((f, 6, 6), poses.dtype).at[rows].add(
                Ji, mode="drop")
            JjC = jnp.tile(eye, (f, 1, 1)).at[rows].add(
                Jj - eye, mode="drop")
            wC = jnp.zeros((f,), poses.dtype).at[rows].add(
                graph.w, mode="drop")
            JjInv = _inv6(JjC)
            winv = 1.0 / (wC + damping)

            def precond(v):
                x = _chain_sqrt_solve(JjInv, JiC, winv, v)
                return x.at[0].set(v[0])

        delta = cg(matvec, b, iters=cg_iters, precond=precond)
        delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
        delta = delta.at[0].set(0.0)
        return poses @ se3.exp_se3(delta), None

    poses, _ = jax.lax.scan(gn_step, graph.poses, None, length=iters)

    T_i = poses[graph.ei]
    T_j = poses[graph.ej]
    zero = jnp.zeros((graph.ei.shape[0], 6), poses.dtype)
    r = jax.vmap(_edge_residual)(zero, zero, T_i, T_j, graph.z)
    cost = jnp.sum(graph.w * jnp.sum(r * r, axis=-1))
    return poses, cost


def distribute_error_linear(poses, idx, i, T_corrected):
    """Reference-parity fallback (loop_closure.py:48-52): linearly smear
    the translation error of frame i over frames idx..i. Kept for
    BASELINE GTvsPOSE-style comparison; `optimize` is the real fix."""
    err = T_corrected[:3, 3] - poses[i, :3, 3]
    f = poses.shape[0]
    t = jnp.arange(f, dtype=poses.dtype)
    frac = jnp.clip((t - idx) / jnp.maximum(i - idx, 1), 0.0, 1.0)
    frac = jnp.where(t > i, 1.0, frac)
    return poses.at[:, :3, 3].add(frac[:, None] * err[None, :])
