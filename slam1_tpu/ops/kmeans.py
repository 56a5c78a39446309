"""Jitted Lloyd-iteration KMeans for visual vocabularies.

Replaces sklearn.KMeans (/root/reference/bag_of_words.py:14,20 — the
only multicore code in the reference). Formulation: descriptors as
{-1,+1}^D vectors make the assignment step one f32/bf16 matmul
(argmax of dot = argmin of Euclidean on constant-norm vectors), and
the update step a one-hot matmul (segment mean). Fixed iteration count,
no convergence branching.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("k", "iters"))
def kmeans_pm1(key, x, mask, k: int, iters: int = 12):
    """KMeans over (M,D) float vectors (rows of constant norm, e.g. ±1).

    Args:
      x: (M,D) float32 data; mask: (M,) validity.
    Returns:
      (centroids (k,D) float32, assignments (M,) int32).
    """
    m, d = x.shape
    # Init: k distinct valid rows via Gumbel top-k on the mask.
    g = -jnp.log(-jnp.log(jax.random.uniform(key, (m,), minval=1e-9,
                                             maxval=1.0)))
    _, init_idx = jax.lax.top_k(jnp.where(mask, g, -jnp.inf), k)
    cent = x[init_idx]                                   # (k,D)
    wm = mask.astype(x.dtype)

    def step(cent, _):
        sim = x @ cent.T                                 # (M,k)
        assign = jnp.argmax(sim, axis=1)
        onehot = jax.nn.one_hot(assign, k, dtype=x.dtype) * wm[:, None]
        sums = onehot.T @ x                              # (k,D)
        counts = jnp.sum(onehot, axis=0)[:, None]        # (k,1)
        new_cent = sums / jnp.maximum(counts, 1.0)
        # Empty clusters keep their previous centroid.
        new_cent = jnp.where(counts > 0, new_cent, cent)
        return new_cent, None

    cent, _ = jax.lax.scan(step, cent, None, length=iters)
    assign = jnp.argmax(x @ cent.T, axis=1).astype(jnp.int32)
    return cent, assign


def assign_words(x, centroids):
    """(M,D) x (k,D) -> (M,) nearest-centroid ids (dot-product metric)."""
    return jnp.argmax(x @ centroids.T, axis=1).astype(jnp.int32)
