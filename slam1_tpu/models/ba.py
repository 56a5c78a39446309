"""Bundle adjustment: batched Schur-complement Levenberg-Marquardt.

Does for real what the reference's dormant BAL-style BA sketches in a
string literal (/root/reference/BundleAdjustment.py:230-466: 9-param
cameras + points, scipy TRF with a hand-built Jacobian sparsity mask)
and what its active pose-only backend approximates (:107-183). No scipy
on device — the batched formulation (SURVEY.md §7 step 6):

  - reprojection residuals + per-observation camera/landmark Jacobians
    in one vmap (analytic structure via jacfwd at zero perturbation);
  - Hessian blocks by segment-sum scatter: Hcc (C,6,6), Hll (L,3,3),
    per-observation coupling W (O,6,3);
  - per-landmark elimination: batched 3x3 inverses (the classic Schur
    trick — landmark blocks are embarrassingly parallel);
  - the reduced camera system solved MATRIX-FREE with block-Jacobi
    preconditioned CG: each matvec is gather -> block products ->
    segment-sum, so nothing bigger than (C,6,6) is ever materialized
    and the observation axis shards cleanly across devices (the
    distributed version psums the camera-side reductions; see
    parallel/dist_ba.py);
  - outer Levenberg-Marquardt with accept/reject damping and Huber
    IRLS weights, fixed iteration counts throughout.

Intrinsics are deliberately FIXED here: KITTI stereo is calibrated and
rectified, so f/k1/k2 are known a-priori and letting them float adds a
near-gauge direction (focal length trades off against depth/baseline
scale, destabilizing the stereo scale anchor that `wr` provides). For
BAL-format datasets with unknown per-camera intrinsics, use
models/bal.py — a 9-dof-camera (rvec, tvec, f, k1, k2) variant of this
same Schur-LM machinery matching the reference's dormant formulation
(/root/reference/BundleAdjustment.py:317-331), validated to recover
perturbed focal length and radial distortion (tests/test_bal.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from slam1_tpu.config import BAConfig
from slam1_tpu.ops import se3
from slam1_tpu.ops.camera import StereoCamera
from slam1_tpu.ops.cg import cg
from slam1_tpu.ops.lsq import huber_weights, inv_spd6


class BAProblem(NamedTuple):
    poses: jnp.ndarray    # (C,4,4) T_world_cam
    points: jnp.ndarray   # (L,3) world landmarks
    cam_idx: jnp.ndarray  # (O,) int32
    lm_idx: jnp.ndarray   # (O,) int32
    uv: jnp.ndarray       # (O,2) observed pixels (left camera)
    w: jnp.ndarray        # (O,) observation weight; 0 = padding
    ur: jnp.ndarray       # (O,) observed right-camera u (stereo)
    wr: jnp.ndarray       # (O,) stereo weight; 0 = monocular obs
    # Optional POSE-PRIOR edges (odometry chain + verified loop
    # closures): residual log(Z^-1 Ti^-1 Tj) between camera rows.
    # Reprojection alone leaves global gauge-adjacent modes soft (only
    # camera 0 is pinned), and a global BA free to bend them will
    # happily trade loop consistency for reprojection cost — measured
    # at config-4 scale: cost 699 -> 29M while keyframe ATE went 3.1 ->
    # 4.9 m. The priors carry the pose graph INTO the BA objective (the
    # reference's active backend is exactly motion priors + a loop
    # constraint, BundleAdjustment.py:107-183 — here they coexist with
    # full landmark reprojection). Empty (E=0) arrays disable.
    pe_i: jnp.ndarray     # (E,) int32 camera row i
    pe_j: jnp.ndarray     # (E,) int32 camera row j
    pe_z: jnp.ndarray     # (E,4,4) measured T_i_j
    pe_w: jnp.ndarray     # (E,) weight; 0 = padding


def make_problem(poses, points, cam_idx, lm_idx, uv, w, ur=None, wr=None,
                 pe_i=None, pe_j=None, pe_z=None, pe_w=None):
    """BAProblem constructor; omitted ur/wr default to monocular,
    omitted pe_* to no pose priors."""
    o = uv.shape[0]
    dt = uv.dtype
    if ur is None:
        ur = jnp.zeros((o,), dt)
    if wr is None:
        wr = jnp.zeros((o,), dt)
    if pe_i is None:
        pe_i = jnp.zeros((0,), jnp.int32)
        pe_j = jnp.zeros((0,), jnp.int32)
        pe_z = jnp.zeros((0, 4, 4), dt)
        pe_w = jnp.zeros((0,), dt)
    return BAProblem(poses=poses, points=points, cam_idx=cam_idx,
                     lm_idx=lm_idx, uv=uv, w=w, ur=ur, wr=wr,
                     pe_i=pe_i, pe_j=pe_j, pe_z=pe_z, pe_w=pe_w)


def _obs_residual(dc, dl, T, X, uv, ur, wr, cam: StereoCamera):
    """Residual of one stereo observation under camera/landmark
    perturbation: [u_left, v_left, right-u] errors. The third component
    is gated by the per-observation stereo weight `wr` (0 = monocular);
    stereo observations anchor the metric scale, which is otherwise a
    gauge freedom of monocular BA (the reference's BAL formulation,
    /root/reference/BundleAdjustment.py:317-350, is monocular and
    scale-free)."""
    Tc = T @ se3.exp_se3(dc)
    Xw = X + dl
    Xc = se3.transform_points(se3.inverse(Tc), Xw[None])[0]
    z = jnp.maximum(Xc[2], 1e-3)
    u = cam.fx * Xc[0] / z + cam.cx
    v = cam.fy * Xc[1] / z + cam.cy
    u_r = cam.fx * (Xc[0] - cam.baseline) / z + cam.cx
    return jnp.stack([u - uv[0], v - uv[1], wr * (u_r - ur)])


def _prior_terms(problem: BAProblem, poses):
    """Residuals (E,6) + Jacobians (E,6,6) of the pose-prior edges at
    `poses` (weight-masked against padding-row NaNs)."""
    from slam1_tpu.models.posegraph import _edge_residual
    T_i = poses[problem.pe_i]
    T_j = poses[problem.pe_j]
    zero = jnp.zeros((problem.pe_i.shape[0], 6), problem.uv.dtype)
    r = jax.vmap(_edge_residual)(zero, zero, T_i, T_j, problem.pe_z)
    Ji = jax.vmap(jax.jacfwd(_edge_residual, argnums=0))(
        zero, zero, T_i, T_j, problem.pe_z)
    Jj = jax.vmap(jax.jacfwd(_edge_residual, argnums=1))(
        zero, zero, T_i, T_j, problem.pe_z)
    ok = (problem.pe_w > 0)[:, None]
    r = jnp.where(ok, r, 0.0)
    Ji = jnp.where(ok[..., None], Ji, 0.0)
    Jj = jnp.where(ok[..., None], Jj, 0.0)
    return r, Ji, Jj, problem.pe_w


def _prior_cost(problem: BAProblem, poses):
    """() quadratic cost of the pose-prior edges at `poses`."""
    if problem.pe_i.shape[0] == 0:
        return jnp.asarray(0.0, problem.uv.dtype)
    r, _, _, w = _prior_terms(problem, poses)
    return jnp.sum(w * jnp.sum(r * r, axis=-1))


def _linearize(problem: BAProblem, cam: StereoCamera, w_irls):
    """Residuals + per-obs Jacobian blocks at the current estimate."""
    T = problem.poses[problem.cam_idx]
    X = problem.points[problem.lm_idx]
    o = problem.uv.shape[0]
    zero6 = jnp.zeros((o, 6), problem.uv.dtype)
    zero3 = jnp.zeros((o, 3), problem.uv.dtype)
    ax = (0, 0, 0, 0, 0, 0, 0, None)
    r = jax.vmap(_obs_residual, in_axes=ax)(
        zero6, zero3, T, X, problem.uv, problem.ur, problem.wr, cam)  # (O,3)
    Jc = jax.vmap(jax.jacfwd(_obs_residual, argnums=0), in_axes=ax)(
        zero6, zero3, T, X, problem.uv, problem.ur, problem.wr, cam)  # (O,3,6)
    Jl = jax.vmap(jax.jacfwd(_obs_residual, argnums=1), in_axes=ax)(
        zero6, zero3, T, X, problem.uv, problem.ur, problem.wr, cam)  # (O,3,3)
    return r, Jc, Jl, w_irls


def _schur_solve(problem, r, Jc, Jl, w, lam, cg_iters: int):
    """One damped GN step via landmark elimination + PCG.

    Per-camera and per-landmark sums over observations are segment sums
    (scatter-adds). A cumsum with differences at the segment ends, the
    scatter-free form this solver used before, loses the f32 precision
    of every segment to the running prefix, which grows with the
    observation count: on a seeded 200-keyframe problem LM stalled 9-12%
    above the cost the distributed solver (exact sums) reached.

    Returns (delta_c (C,6), delta_l (L,3)).
    """
    C = problem.poses.shape[0]
    L = problem.points.shape[0]
    ci, li = problem.cam_idx, problem.lm_idx
    w2 = w[:, None, None]

    def seg_cam(vals):
        return jax.ops.segment_sum(vals, ci, num_segments=C)

    def seg_lm(vals):
        return jax.ops.segment_sum(vals, li, num_segments=L)

    Hcc = seg_cam(jnp.einsum("oai,oaj->oij", Jc, Jc) * w2)
    Hll = seg_lm(jnp.einsum("oai,oaj->oij", Jl, Jl) * w2)
    W = jnp.einsum("oai,oaj->oij", Jc, Jl) * w2                   # (O,6,3)
    bc = -seg_cam(jnp.einsum("oai,oa->oi", Jc, r * w[:, None]))
    bl = -seg_lm(jnp.einsum("oai,oa->oi", Jl, r * w[:, None]))

    # Pose-prior edges: camera-side only, so they ride OUTSIDE the
    # landmark elimination — gradient into bc; the DIAGONAL curvature
    # blocks Jpi'Jpi / Jpj'Jpj are folded into Hcc so LM damping and
    # the block-Jacobi preconditioner see them (prior weights are
    # 1e4-1e6 — orders above per-observation reprojection curvature;
    # leaving them matvec-only starved the preconditioner of the
    # DOMINANT curvature and CG returned junk steps at small lam:
    # measured at config-4 scale as 1 accepted LM step in 15). Only
    # the (i,j) CROSS blocks stay matrix-free in the CG matvec.
    has_prior = problem.pe_i.shape[0] > 0
    if has_prior:
        rp, Jpi, Jpj, wp = _prior_terms(problem, problem.poses)
        wp2 = wp[:, None]
        wp3 = wp[:, None, None]
        bc = bc - (jnp.zeros((C, 6), r.dtype)
                   .at[problem.pe_i].add(
                       jnp.einsum("eab,ea->eb", Jpi, rp * wp2))
                   .at[problem.pe_j].add(
                       jnp.einsum("eab,ea->eb", Jpj, rp * wp2)))
        Hcc = (Hcc
               .at[problem.pe_i].add(
                   jnp.einsum("eai,eaj->eij", Jpi, Jpi) * wp3)
               .at[problem.pe_j].add(
                   jnp.einsum("eai,eaj->eij", Jpj, Jpj) * wp3))

    eye6 = jnp.eye(6, dtype=r.dtype)
    eye3 = jnp.eye(3, dtype=r.dtype)
    Hcc_d = Hcc + lam * _diag_only(Hcc) + 1e-6 * eye6
    Hll_d = Hll + lam * _diag_only(Hll) + 1e-6 * eye3
    # Closed-form batched 3x3 inverse (adjugate/det): one elementwise
    # pass over L ~ 10^5 blocks instead of a batched LU.
    Hll_inv = _inv3x3(Hll_d)                                      # (L,3,3)

    btil = bc - seg_cam(
        jnp.einsum("oij,oj->oi", W,
                   jnp.einsum("lij,lj->li", Hll_inv, bl)[li]))
    btil = btil.at[0].set(0.0)                                    # gauge

    def matvec(x):
        u = jnp.einsum("oij,oi->oj", W, x[ci])                    # (O,3)
        s = seg_lm(u)
        v = jnp.einsum("lij,lj->li", Hll_inv, s)
        y = jnp.einsum("oij,oj->oi", W, v[li])                    # (O,6)
        out = jnp.einsum("cij,cj->ci", Hcc_d, x)
        out = out - seg_cam(y)
        if has_prior:
            # Cross blocks only — the diagonal blocks are inside Hcc_d.
            out = (out
                   .at[problem.pe_i].add(
                       jnp.einsum("eab,ea->eb", Jpi,
                                  wp2 * jnp.einsum("eab,eb->ea", Jpj,
                                                   x[problem.pe_j])))
                   .at[problem.pe_j].add(
                       jnp.einsum("eab,ea->eb", Jpj,
                                  wp2 * jnp.einsum("eab,eb->ea", Jpi,
                                                   x[problem.pe_i]))))
        return out.at[0].set(x[0])                                # gauge

    # closed-form blockwise SPD inverse instead of a batched LU over
    # C ~ 1024 cameras
    Minv = inv_spd6(Hcc_d)

    def precond(v):
        return jnp.einsum("cij,cj->ci", Minv, v)

    dc = cg(matvec, btil, iters=cg_iters, precond=precond)
    dc = dc.at[0].set(0.0)

    u = jnp.einsum("oij,oi->oj", W, dc[ci])
    s = seg_lm(u)
    dl = jnp.einsum("lij,lj->li", Hll_inv, bl - s)
    return dc, dl


def _schur_solve_direct(problem, r, Jc, Jl, w, lam):
    """One damped GN step via landmark elimination + a DENSE solve of
    the reduced camera system.

    For a local window (C <= ~16 cameras) the reduced system is only
    (6C x 6C) — building it densely and solving by LU is exact and far
    cheaper than 64 matrix-free CG sweeps over the observation arrays
    (the CG path exists for global BA where C is large; see
    `_schur_solve`). Memory: the per-landmark coupling tensor U is
    (L, C, 6, 3) — at window scale (L ~ 2.5k, C = 5) under 1 MB.
    """
    C = problem.poses.shape[0]
    L = problem.points.shape[0]
    ci, li = problem.cam_idx, problem.lm_idx
    w2 = w[:, None, None]

    Hcc = jnp.zeros((C, 6, 6), r.dtype).at[ci].add(
        jnp.einsum("oai,oaj->oij", Jc, Jc) * w2)
    Hll = jnp.zeros((L, 3, 3), r.dtype).at[li].add(
        jnp.einsum("oai,oaj->oij", Jl, Jl) * w2)
    W = jnp.einsum("oai,oaj->oij", Jc, Jl) * w2                   # (O,6,3)
    bc = -jnp.zeros((C, 6), r.dtype).at[ci].add(
        jnp.einsum("oai,oa->oi", Jc, r * w[:, None]))
    bl = -jnp.zeros((L, 3), r.dtype).at[li].add(
        jnp.einsum("oai,oa->oi", Jl, r * w[:, None]))

    # Pose-prior edges (camera-side only): DIAGONAL curvature folds
    # into Hcc before damping (mirroring _schur_solve — LM damping
    # must see the dominant curvature), cross blocks + gradient added
    # to the dense system below.
    has_prior = problem.pe_i.shape[0] > 0
    if has_prior:
        rp, Jpi, Jpj, wp = _prior_terms(problem, problem.poses)
        wp2 = wp[:, None]
        wp3 = wp[:, None, None]
        pi, pj = problem.pe_i, problem.pe_j
        Hcc = (Hcc
               .at[pi].add(jnp.einsum("eai,eaj->eij", Jpi, Jpi) * wp3)
               .at[pj].add(jnp.einsum("eai,eaj->eij", Jpj, Jpj) * wp3))
        bc = bc - (jnp.zeros((C, 6), r.dtype)
                   .at[pi].add(jnp.einsum("eab,ea->eb", Jpi, rp * wp2))
                   .at[pj].add(jnp.einsum("eab,ea->eb", Jpj, rp * wp2)))

    eye6 = jnp.eye(6, dtype=r.dtype)
    eye3 = jnp.eye(3, dtype=r.dtype)
    Hcc_d = Hcc + lam * _diag_only(Hcc) + 1e-6 * eye6
    Hll_d = Hll + lam * _diag_only(Hll) + 1e-6 * eye3
    Hll_inv = _inv3x3(Hll_d)                                      # (L,3,3)

    # Per-landmark camera coupling U[l] = sum_{obs of l} W placed in the
    # observing camera's 6-block.
    U = jnp.zeros((L, C, 6, 3), r.dtype).at[li, ci].add(W)
    UH = jnp.einsum("lcij,ljk->lcik", U, Hll_inv)                 # (L,C,6,3)
    S_off = jnp.einsum("lcik,ldjk->cidj", UH, U)                  # (C,6,C,6)
    idx = jnp.arange(C)
    S = (jnp.zeros((C, 6, C, 6), r.dtype).at[idx, :, idx, :].set(Hcc_d)
         - S_off)
    btil = bc - jnp.einsum("lcik,lk->ci", UH, bl)                 # (C,6)

    if has_prior:
        # Cross blocks only — diagonal blocks already damped in Hcc_d.
        S = (S
             .at[pi, :, pj, :].add(
                 jnp.einsum("eai,eaj->eij", Jpi, Jpj * wp3))
             .at[pj, :, pi, :].add(
                 jnp.einsum("eai,eaj->eij", Jpj, Jpi * wp3)))

    # Gauge: camera 0 block acts as identity (rows/cols zeroed, diag 1),
    # matching the CG path's `.at[0].set(x[0])`.
    S = S.at[0].set(0.0).at[:, :, 0].set(0.0)
    S = S.at[0, :, 0, :].set(eye6)
    btil = btil.at[0].set(0.0)

    dc = jnp.linalg.solve(S.reshape(C * 6, C * 6),
                          btil.reshape(C * 6)).reshape(C, 6)
    dc = dc.at[0].set(0.0)

    u = jnp.einsum("oij,oi->oj", W, dc[ci])
    s = jnp.zeros((L, 3), r.dtype).at[li].add(u)
    dl = jnp.einsum("lij,lj->li", Hll_inv, bl - s)
    return dc, dl


def _diag_only(blocks):
    d = jnp.diagonal(blocks, axis1=-2, axis2=-1)
    return jax.vmap(jnp.diag)(d)


def _inv3x3(m):
    """Batched closed-form 3x3 inverse via the adjugate (elementwise)."""
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


def _cost(problem: BAProblem, cam, huber_delta):
    T = problem.poses[problem.cam_idx]
    X = problem.points[problem.lm_idx]
    o = problem.uv.shape[0]
    zero6 = jnp.zeros((o, 6), problem.uv.dtype)
    zero3 = jnp.zeros((o, 3), problem.uv.dtype)
    r = jax.vmap(_obs_residual, in_axes=(0, 0, 0, 0, 0, 0, 0, None))(
        zero6, zero3, T, X, problem.uv, problem.ur, problem.wr, cam)
    r2 = jnp.sum(r * r, axis=-1)
    hw = huber_weights(r2, huber_delta)
    return jnp.sum(problem.w * hw * r2), r, hw


class BATrace(NamedTuple):
    """Per-LM-iteration convergence diagnostics (BAConfig.lm_iters long).

    `cost` is the accepted cost after each iteration (flat segments =
    rejected LM steps); `n_obs` the observation count surviving BOTH the
    IRLS weight and the graduated outlier cut at that iteration — the
    two together attribute a weak reduction to a stalled LM vs an
    outlier cut starving the problem of support vs CG non-convergence.
    `lam`/`accept`/`dc_norm` localize a stall further: rejected steps at
    tiny lam = overshooting (CG under-convergence or nonlinearity),
    rejected steps at huge lam with dc_norm -> 0 = the f32 cost
    comparison can no longer resolve genuine descent."""
    cost: jnp.ndarray    # (lm_iters,)
    n_obs: jnp.ndarray   # (lm_iters,) int32
    lam: jnp.ndarray     # (lm_iters,) damping used for the iteration's step
    accept: jnp.ndarray  # (lm_iters,) bool
    dc_norm: jnp.ndarray  # (lm_iters,) max camera-step norm (pre-accept)


@functools.partial(jax.jit, static_argnames=("cfg", "return_trace"))
def bundle_adjust(problem: BAProblem, cam: StereoCamera,
                  cfg: BAConfig, return_trace: bool = False
                  ) -> Tuple[BAProblem, jnp.ndarray]:
    """Full LM bundle adjustment. Camera 0 is gauge-fixed.

    Returns (optimized problem, final cost), plus a BATrace when
    `return_trace` (static) — the scan collects it either way; the flag
    only controls whether it is an output.

    LM acceptance is judged on the SAME objective the step was computed
    for: the TRUNCATED robust cost at the iteration's graduated cut,
    sum_i w_i * min(huber(r_i), huber(cut)). Judging acceptance on the
    full Huber cost while stepping on the truncated objective (the r4
    design) deadlocks at high residual levels — at config-4 scale
    (mean residual ~100 px against a 16-128 px cut) every step improved
    the truncated objective, worsened some far-outlier residuals, and
    was rejected: 15 iterations, zero accepted steps, flat cost trace.
    The truncation must SATURATE (excluded observations contribute the
    constant cap), not vanish: pricing candidates over a frozen active
    set lets a step push excluded residuals arbitrarily worse for free
    and measurably degrades clean problems. The reported cost/trace
    stays the FULL Huber cost so traces are comparable across
    iterations and runs.
    """

    def trunc_cost(hw, r2, cap):
        contrib = hw * r2                      # huber(r): r2 or delta*r
        return jnp.sum(problem.w * jnp.minimum(contrib, cap))

    def lm_step(carry, t):
        poses, points, lam = carry
        p = problem._replace(poses=poses, points=points)
        full_cur, r, hw = _cost(p, cam, cfg.huber_delta)
        w = problem.w * hw
        r2 = jnp.sum(r * r, axis=-1)
        if cfg.outlier_px:
            # Graduated rejection (GNC-style truncated loss): the cut
            # starts 8x loose so a poor initial guess isn't starved of
            # support, and tightens to outlier_px over iterations (see
            # BAConfig.outlier_px). The STEP zero-weights observations
            # beyond the cut; the OBJECTIVE saturates them at the cap.
            cut = cfg.outlier_px * jnp.maximum(
                1.0, 8.0 * 0.5 ** t.astype(r.dtype))
            active = (r2 < cut * cut).astype(r.dtype)
            w = w * active
            cap = huber_weights(cut * cut, cfg.huber_delta) * cut * cut
        else:
            active = jnp.ones_like(r2)
            cap = jnp.asarray(jnp.inf, r.dtype)
        pc_cur = _prior_cost(problem, poses)
        cost_cur = trunc_cost(hw, r2, cap) + pc_cur
        full_cur = full_cur + pc_cur
        r_, Jc, Jl, w_ = _linearize(p, cam, w)
        if problem.poses.shape[0] <= 16:
            dc, dl = _schur_solve_direct(p, r_, Jc, Jl, w_, lam)
        else:
            dc, dl = _schur_solve(p, r_, Jc, Jl, w_, lam, cfg.cg_iters)
        dc = jnp.where(jnp.isfinite(dc), dc, 0.0)
        dl = jnp.where(jnp.isfinite(dl), dl, 0.0)
        new_poses = poses @ se3.exp_se3(dc)
        new_points = points + dl
        full_new, r_new, hw_new = _cost(
            problem._replace(poses=new_poses, points=new_points), cam,
            cfg.huber_delta)
        r2_new = jnp.sum(r_new * r_new, axis=-1)
        pc_new = _prior_cost(problem, new_poses)
        cost_new = trunc_cost(hw_new, r2_new, cap) + pc_new
        full_new = full_new + pc_new
        accept = cost_new < cost_cur
        poses = jnp.where(accept, new_poses, poses)
        points = jnp.where(accept, new_points, points)
        lam = jnp.where(accept, lam / cfg.lm_lambda_down,
                        lam * cfg.lm_lambda_up)
        lam = jnp.clip(lam, 1e-9, 1e6)
        n_surv = jnp.sum((w > 0).astype(jnp.int32))
        full = jnp.where(accept, full_new, full_cur)
        lam_used = jnp.where(accept, lam * cfg.lm_lambda_down,
                             lam / cfg.lm_lambda_up)  # pre-update value
        dc_norm = jnp.max(jnp.linalg.norm(dc, axis=-1))
        return (poses, points, lam), (full, n_surv, lam_used, accept,
                                      dc_norm)

    (poses, points, _), (costs, n_obs, lams, accepts, dc_norms) = jax.lax.scan(
        lm_step,
        (problem.poses, problem.points,
         jnp.asarray(cfg.lm_lambda0, problem.uv.dtype)),
        jnp.arange(cfg.lm_iters))
    cost, _, _ = _cost(problem._replace(poses=poses, points=points),
                       cam, cfg.huber_delta)
    cost = cost + _prior_cost(problem, poses)
    out = problem._replace(poses=poses, points=points)
    if return_trace:
        return out, cost, BATrace(cost=costs, n_obs=n_obs, lam=lams,
                                  accept=accepts, dc_norm=dc_norms)
    return out, cost


def window_problem(poses, points, cam_idx, lm_idx, uv, w,
                   first_cam: int, n_cams: int, ur=None, wr=None):
    """Restrict a BA problem to a camera window [first, first+n): weights
    of out-of-window observations are zeroed; cameras outside stay fixed
    because their deltas receive no residual support (and gauge pinning
    keeps the solve well-posed)."""
    in_win = (cam_idx >= first_cam) & (cam_idx < first_cam + n_cams)
    return make_problem(poses=poses, points=points, cam_idx=cam_idx,
                        lm_idx=lm_idx, uv=uv,
                        w=jnp.where(in_win, w, 0.0), ur=ur, wr=wr)
