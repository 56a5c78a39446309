"""Batched nonlinear least-squares: fixed-iteration Gauss-Newton and
Levenberg-Marquardt.

Replaces scipy.optimize.least_squares (reference BundleAdjustment.py:182,
visual_odometry.py:146) with jit/vmap-friendly solvers: static iteration
counts (lax.scan), masked residual weights instead of ragged point sets,
Jacobians via jacfwd for small parameter blocks. These drive the vmapped
RANSAC hypothesis refinement, PnP polish, and pose-graph/BA backends.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp


def weighted_normal_eqs(J, r, w):
    """H = J^T W J, g = J^T W r for (M,P) Jacobian, (M,) residual/weights."""
    Jw = J * w[:, None]
    return J.T @ Jw, Jw.T @ r


@functools.partial(jax.jit, static_argnames=("residual_fn", "iters"))
def gauss_newton(residual_fn: Callable, x0, iters: int = 10,
                 damping: float = 1e-6):
    """Minimize ||w * r(x)||^2 with fixed-iteration damped Gauss-Newton.

    residual_fn(x) -> (r (M,), w (M,)). w may encode validity masks.
    Returns (x, final_cost).
    """
    p = x0.shape[-1]
    eye = jnp.eye(p, dtype=x0.dtype)

    def step(x, _):
        r, w = residual_fn(x)
        J = jax.jacfwd(lambda z: residual_fn(z)[0])(x)
        H, g = weighted_normal_eqs(J, r, w)
        dx = jnp.linalg.solve(H + damping * eye, g)
        # Guard NaN/inf steps (singular systems with all-masked residuals).
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        return x - dx, None

    x, _ = jax.lax.scan(step, x0, None, length=iters)
    r, w = residual_fn(x)
    return x, jnp.sum(w * r * r)


@functools.partial(jax.jit,
                   static_argnames=("residual_fn", "iters"))
def levenberg_marquardt(residual_fn: Callable, x0, iters: int = 15,
                        lambda0: float = 1e-3, lambda_up: float = 4.0,
                        lambda_down: float = 2.0):
    """LM with multiplicative damping and accept/reject steps.

    Same residual contract as gauss_newton. Fixed iteration count; a
    rejected step only grows lambda (no early exit — XLA-friendly).
    Returns (x, final_cost).
    """
    p = x0.shape[-1]
    eye = jnp.eye(p, dtype=x0.dtype)

    def cost(x):
        r, w = residual_fn(x)
        return jnp.sum(w * r * r)

    def step(carry, _):
        x, lam, c = carry
        r, w = residual_fn(x)
        J = jax.jacfwd(lambda z: residual_fn(z)[0])(x)
        H, g = weighted_normal_eqs(J, r, w)
        dx = jnp.linalg.solve(H + lam * (jnp.diag(jnp.diag(H)) + 1e-9 * eye),
                              g)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        x_new = x - dx
        c_new = cost(x_new)
        accept = c_new < c
        x = jnp.where(accept, x_new, x)
        c = jnp.where(accept, c_new, c)
        lam = jnp.where(accept, lam / lambda_down, lam * lambda_up)
        lam = jnp.clip(lam, 1e-10, 1e8)
        return (x, lam, c), c

    (x, _, c), _ = jax.lax.scan(
        step, (x0, jnp.asarray(lambda0, x0.dtype), cost(x0)), None,
        length=iters)
    return x, c


def huber_weights(r2, delta: float):
    """IRLS weights for the Huber loss given squared residual norms."""
    d2 = delta * delta
    return jnp.where(r2 <= d2, 1.0, jnp.sqrt(d2 / jnp.maximum(r2, 1e-12)))


def inv3x3(m):
    """Batched closed-form 3x3 inverse via the adjugate — one
    elementwise pass instead of a batched LU in GN/LM inner loops."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * h
    cb = c * h - b * i
    cc = b * f - c * e
    cd = f * g - d * i
    ce = a * i - c * g
    cf = c * d - a * f
    cg = d * h - e * g
    ch = b * g - a * h
    ci = a * e - b * d
    det = a * ca + b * cd + c * cg
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
    adj = jnp.stack([
        jnp.stack([ca, cb, cc], -1),
        jnp.stack([cd, ce, cf], -1),
        jnp.stack([cg, ch, ci], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def inv_spd6(H):
    """Batched closed-form inverse of a 6x6 SPD matrix via 3x3
    blockwise Schur complement (all closed-form 3x3 inverses — no
    scalarized LU). H = [[A, B], [B^T, D]]:
        S   = D - B^T A^-1 B        (Schur complement)
        Hinv = [[A^-1 + A^-1 B S^-1 B^T A^-1,  -A^-1 B S^-1],
                [-S^-1 B^T A^-1,                S^-1       ]]
    """
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    D = H[..., 3:, 3:]
    Ai = inv3x3(A)
    Bt = jnp.swapaxes(B, -1, -2)
    AiB = Ai @ B
    S = D - Bt @ AiB
    Si = inv3x3(S)
    top_right = -AiB @ Si
    top_left = Ai + AiB @ Si @ jnp.swapaxes(AiB, -1, -2)
    bot_left = jnp.swapaxes(top_right, -1, -2)
    top = jnp.concatenate([top_left, top_right], axis=-1)
    bot = jnp.concatenate([bot_left, Si], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def solve_spd6(H, g):
    """Solve the 6x6 SPD system H x = g (batched) via inv_spd6."""
    return (inv_spd6(H) @ g[..., None])[..., 0]
