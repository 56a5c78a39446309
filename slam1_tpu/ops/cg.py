"""Preconditioned conjugate gradient with implicit matvec.

The backend solvers (pose graph, reduced camera system of the Schur BA)
never materialize their Hessians: CG consumes a matvec closure built
from per-edge/per-observation gather + segment-sum, which is the
jit-friendly sparse structure (static shapes, no CSR). Fixed iteration
count (lax.scan) — no data-dependent convergence branch under jit.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp


def cg(matvec: Callable, b, x0=None, iters: int = 64, precond=None,
       eps: float = 1e-12):
    """Solve A x = b. Works on arbitrary pytrees/arrays (flattened dot).

    matvec/precond: array -> array of same shape.
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if precond is None:
        precond = lambda v: v

    def dot(u, v):
        return jnp.sum(u * v)

    r0 = b - matvec(x0)
    z0 = precond(r0)

    def step(carry, _):
        x, r, z, p, rz = carry
        Ap = matvec(p)
        denom = dot(p, Ap)
        alpha = rz / jnp.where(jnp.abs(denom) < eps, eps, denom)
        # freeze updates once the residual has vanished
        alive = rz > eps
        alpha = jnp.where(alive, alpha, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.where(jnp.abs(rz) < eps, eps, rz)
        beta = jnp.where(alive, beta, 0.0)
        p = z + beta * p
        return (x, r, z, p, rz_new), None

    carry0 = (x0, r0, z0, z0, dot(r0, z0))
    (x, r, _, _, _), _ = jax.lax.scan(step, carry0, None, length=iters)
    return x
