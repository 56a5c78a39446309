"""Keyframe-axis sharded pose-graph optimization (halo exchange).

The trajectory is the SLAM analogue of a transformer's sequence axis
(SURVEY.md §2/§5: "scaling sequence length = scaling trajectory
length"). This module shards the pose-graph Gauss-Newton solve over a
mesh axis: each device owns a CONTIGUOUS block of B poses and the
odometry edges that start inside its block. The only cross-device
coupling of the chain is at block boundaries, handled ring-style:

  - each GN/CG step ppermutes every device's FIRST pose/delta to its
    left neighbour (one (6,) / (4,4) halo per step), and
  - boundary gradient contributions ride the reverse ppermute.

Loop-closure edges connect arbitrary pose pairs; with a fixed small
capacity (MAX_LOOP_EDGES) their endpoint states are assembled with one
masked-gather + psum per step (O(E) bytes), and their Hessian
contributions scatter only into locally-owned rows.

The reference has no counterpart (its backend flattens the whole
trajectory into one scipy vector, /root/reference/BundleAdjustment.py:
188-200); this is the part of the design that lets trajectory length
scale past one chip's HBM.

Parity: tests/test_dist_pgo.py checks this against models/posegraph.py
on a virtual 8-device CPU mesh.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from slam1_tpu.models.posegraph import (_chain_sqrt_solve, _edge_residual,
                                        _inv6)
from slam1_tpu.ops import se3


def _ring_perm(n, shift):
    """ppermute perm sending device i -> i+shift (mod n)."""
    return [(i, (i + shift) % n) for i in range(n)]


def _local_pgo(poses_blk, z_blk, w_blk, le_i, le_j, le_z, le_w,
               *, axis: str, iters: int, cg_iters: int, damping: float):
    """Per-device pose-graph GN. poses_blk (B,4,4) is this device's
    contiguous pose block; z_blk/w_blk (B,4,4)/(B,) are the odometry
    edges starting at its poses (edge k: global pose sB+k -> sB+k+1,
    the last one crossing into the right neighbour; the final global
    slot is weight-0 padding). Loop-edge arrays are replicated."""
    B = poses_blk.shape[0]
    S = jax.lax.axis_size(axis)
    s = jax.lax.axis_index(axis)
    left = _ring_perm(S, -1)    # send to left neighbour (i -> i-1)
    right = _ring_perm(S, +1)
    lo = s * B
    E = le_i.shape[0]
    dt = poses_blk.dtype

    own_i = (le_i >= lo) & (le_i < lo + B)
    own_j = (le_j >= lo) & (le_j < lo + B)
    li_loc = jnp.clip(le_i - lo, 0, B - 1)
    lj_loc = jnp.clip(le_j - lo, 0, B - 1)

    def gather_loop(x):
        """Replicated (E, ...) of a blockwise-sharded per-pose array."""
        xi = jnp.where(own_i.reshape((E,) + (1,) * (x.ndim - 1)),
                       x[li_loc], 0.0)
        xj = jnp.where(own_j.reshape((E,) + (1,) * (x.ndim - 1)),
                       x[lj_loc], 0.0)
        return (jax.lax.psum(xi, axis), jax.lax.psum(xj, axis))

    def halo_first(x):
        """Right neighbour's first row (pose (s+1)B), ring-shifted."""
        return jax.lax.ppermute(x[0], axis, left)

    def scatter_boundary(out, contrib):
        """Add each device's boundary-edge contribution into its right
        neighbour's row 0."""
        recv = jax.lax.ppermute(contrib, axis, right)
        return out.at[0].add(recv)

    def pin(outv, val_row0):
        """Gauge: global pose 0 (device 0, row 0)."""
        row0 = jnp.where(s == 0, val_row0, outv[0])
        return outv.at[0].set(row0)

    def gn_step(poses, _):
        halo_T = halo_first(poses)                       # (4,4)
        T_i = poses                                      # (B,4,4)
        T_j = jnp.concatenate([poses[1:], halo_T[None]])
        zero = jnp.zeros((B, 6), dt)
        r0 = jax.vmap(_edge_residual)(zero, zero, T_i, T_j, z_blk)
        Ji = jax.vmap(jax.jacfwd(_edge_residual, argnums=0))(
            zero, zero, T_i, T_j, z_blk)                 # (B,6,6)
        Jj = jax.vmap(jax.jacfwd(_edge_residual, argnums=1))(
            zero, zero, T_i, T_j, z_blk)
        w = w_blk[:, None]
        # Hard-mask disabled edges: padding z may be singular (e.g. the
        # final global slot, or the wrap edge device S-1 -> 0), whose
        # residual/Jacobian can be NaN — and 0 * nan = nan would poison
        # the whole solve. where() on the computed values kills it.
        valid = (w_blk > 0)[:, None]
        r0 = jnp.where(valid, r0, 0.0)
        Ji = jnp.where(valid[..., None], Ji, 0.0)
        Jj = jnp.where(valid[..., None], Jj, 0.0)

        # Loop edges (replicated compute, local scatter).
        Tle_i, Tle_j = gather_loop(poses)
        zl = jnp.zeros((E, 6), dt)
        rl = jax.vmap(_edge_residual)(zl, zl, Tle_i, Tle_j, le_z)
        Jli = jax.vmap(jax.jacfwd(_edge_residual, argnums=0))(
            zl, zl, Tle_i, Tle_j, le_z)
        Jlj = jax.vmap(jax.jacfwd(_edge_residual, argnums=1))(
            zl, zl, Tle_i, Tle_j, le_z)
        wl = le_w[:, None]
        lvalid = (le_w > 0)[:, None]
        rl = jnp.where(lvalid, rl, 0.0)
        Jli = jnp.where(lvalid[..., None], Jli, 0.0)
        Jlj = jnp.where(lvalid[..., None], Jlj, 0.0)

        def scatter(y_odo, y_loop):
            """y_odo (B,6) per-odometry-edge, y_loop (E,6) per-loop-edge
            -> (B,6) per-local-pose accumulation (with halos)."""
            out = jnp.einsum("eab,ea->eb", Ji, y_odo)
            out = out.at[1:].add(
                jnp.einsum("eab,ea->eb", Jj[:-1], y_odo[:-1]))
            out = scatter_boundary(
                out, jnp.einsum("ab,a->b", Jj[-1], y_odo[-1]))
            out = out.at[jnp.where(own_i, li_loc, B)].add(
                jnp.einsum("eab,ea->eb", Jli, y_loop), mode="drop")
            out = out.at[jnp.where(own_j, lj_loc, B)].add(
                jnp.einsum("eab,ea->eb", Jlj, y_loop), mode="drop")
            return out

        b = -scatter(r0 * w, rl * wl)

        def matvec(x):
            halo_x = halo_first(x)                       # (6,)
            xi = x
            xj = jnp.concatenate([x[1:], halo_x[None]])
            y = (jnp.einsum("eab,eb->ea", Ji, xi)
                 + jnp.einsum("eab,eb->ea", Jj, xj)) * w
            xle_i, xle_j = gather_loop(x)
            yl = (jnp.einsum("eab,eb->ea", Jli, xle_i)
                  + jnp.einsum("eab,eb->ea", Jlj, xle_j)) * wl
            out = scatter(y, yl) + damping * x
            return pin(out, x[0])

        b = pin(b, jnp.zeros(6, dt))

        # PER-BLOCK chain preconditioner (block-Jacobi over devices,
        # exact square-root chain solve inside each device's contiguous
        # pose block — models/posegraph._chain_sqrt_solve): each PCG
        # iteration then propagates corrections across a whole block at
        # once, so convergence scales with #shards + #loop edges
        # instead of the global pose count (unpreconditioned CG
        # measurably stagnated ~0.15 m from the GN fixed point on a
        # 128-pose chain even at 3F iterations in f32). Only the
        # cross-boundary odometry edges and loop edges are left to CG.
        eye6 = jnp.eye(6, dtype=dt)
        JiC = jnp.concatenate([jnp.zeros((1, 6, 6), dt), Ji[:B - 1]])
        JjC = jnp.concatenate([eye6[None], Jj[:B - 1]])
        wC = jnp.concatenate([jnp.zeros((1,), dt), w_blk[:B - 1]])
        dead = (wC <= 0)
        JiC = jnp.where(dead[:, None, None], 0.0, JiC)
        JjC = jnp.where(dead[:, None, None], eye6, JjC)
        JjInv = _inv6(JjC)
        winv = 1.0 / (wC + damping)
        # Row 0 has no chain edge inside this block (its edge belongs
        # to the left neighbour), but it DOES have its own outgoing
        # edge's Ji^T Ji in H — approximate row 0 of M with that block
        # (plus damping) instead of damping alone: a 1/damping = 1e4
        # row scaling poisons the preconditioned spectrum and stalls
        # f32 PCG.
        from slam1_tpu.ops.lsq import inv_spd6
        D0 = (w_blk[0] * (Ji[0].T @ Ji[0])
              + damping * jnp.eye(6, dtype=dt))
        D0inv = inv_spd6(D0)

        def precond(v):
            x = _chain_sqrt_solve(JjInv, JiC, winv, v)
            row0 = jnp.where(s == 0, v[0], D0inv @ v[0])
            return x.at[0].set(row0)

        # PCG with psum'd reductions (distributed dot products).
        def pdot(a_, b_):
            return jax.lax.psum(jnp.vdot(a_, b_), axis)

        def cg_body(carry, _):
            x, rr, p, rz = carry
            Ap = matvec(p)
            alpha = rz / (pdot(p, Ap) + 1e-30)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = pdot(rr, z)
            p = z + (rz_new / (rz + 1e-30)) * p
            return (x, rr, p, rz_new), None

        # zeros() is unvarying over the manual axis while the CG body's
        # outputs are varying; pcast the initial carry to match (jax
        # 0.9 shard_map vma check).
        x0 = jax.lax.pcast(jnp.zeros((B, 6), dt), (axis,), to="varying")
        z0 = precond(b)
        (delta, _, _, _), _ = jax.lax.scan(
            cg_body, (x0, b, z0, pdot(b, z0)), None, length=cg_iters)
        delta = pin(delta, jnp.zeros(6, dt))
        return poses @ se3.exp_se3(delta), None

    poses, _ = jax.lax.scan(gn_step, poses_blk, None, length=iters)

    # Final cost (odometry local + loop on device 0 only).
    halo_T = halo_first(poses)
    T_j = jnp.concatenate([poses[1:], halo_T[None]])
    zero = jnp.zeros((B, 6), dt)
    r = jax.vmap(_edge_residual)(zero, zero, poses, T_j, z_blk)
    r = jnp.where((w_blk > 0)[:, None], r, 0.0)
    c_odo = jnp.sum(w_blk * jnp.sum(r * r, axis=-1))
    Tle_i, Tle_j = gather_loop(poses)
    zl = jnp.zeros((E, 6), dt)
    rl = jax.vmap(_edge_residual)(zl, zl, Tle_i, Tle_j, le_z)
    rl = jnp.where((le_w > 0)[:, None], rl, 0.0)
    c_loop = jnp.where(s == 0,
                       jnp.sum(le_w * jnp.sum(rl * rl, axis=-1)), 0.0)
    cost = jax.lax.psum(c_odo + c_loop, axis)
    return poses, cost


@functools.partial(jax.jit,
                   static_argnames=("mesh", "axis", "iters", "cg_iters"))
def optimize_sharded(poses, z_odo, w_odo, le_i, le_j, le_z, le_w,
                     mesh: Mesh, axis: str = "lm", iters: int = 10,
                     cg_iters: int = 50, damping: float = 1e-4):
    """Keyframe-axis sharded pose-graph GN.

    Args:
      poses: (F,4,4); F must divide evenly by mesh.shape[axis].
      z_odo: (F,4,4) odometry measurements, z_odo[k] = T_k^-1 T_{k+1};
        slot F-1 is padding and must carry w_odo[F-1] == 0.
      w_odo: (F,) edge weights (0 disables).
      le_*: fixed-capacity loop-closure edges (replicated).

    Returns (optimized poses (F,4,4), final cost ()).
    """
    f = poses.shape[0]
    S = mesh.shape[axis]
    assert f % S == 0, (f, S)
    # Replace disabled edges' measurements with identity so padding
    # (often all-zeros, hence singular) can't generate NaNs upstream of
    # the weight masks.
    eye = jnp.eye(4, dtype=poses.dtype)
    z_odo = jnp.where((w_odo > 0)[:, None, None], z_odo, eye)
    le_z = jnp.where((le_w > 0)[:, None, None], le_z, eye)
    fn = shard_map(
        functools.partial(_local_pgo, axis=axis, iters=iters,
                          cg_iters=cg_iters, damping=damping),
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P(), P(), P()),
        out_specs=(P(axis), P()),
    )
    return fn(poses, z_odo, w_odo, le_i, le_j, le_z, le_w)
