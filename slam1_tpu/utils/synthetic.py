"""Synthetic stereo-sequence generator with exact ground truth.

The reference is only runnable against a local KITTI download (hardcoded
path, /root/reference/main.py:34); this module provides a self-contained
substitute: a random textured 3D landmark field rendered into a rectified
stereo pair along a known trajectory. Used by tests (oracle: GT poses /
GT 3D points are exact) and by bench.py when no KITTI data is present.

Rendering is a fixed-shape scatter-add of per-landmark texture patches at
the projected pixel locations — fully jittable, so long benches can
render on-device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam1_tpu.ops import se3
from slam1_tpu.ops.camera import StereoCamera, project_stereo


class SyntheticWorld(NamedTuple):
    points: jnp.ndarray    # (P,3)   world-frame landmarks
    patches: jnp.ndarray   # (P,ps,ps) texture stamped at each landmark
    poses: jnp.ndarray     # (F,4,4) GT world-from-camera (left) poses
    cam: StereoCamera


def make_trajectory(n_frames: int, kind: str = "arc",
                    speed: float = 1.0, dtype=jnp.float32) -> jnp.ndarray:
    """(F,4,4) world-from-camera poses. Camera looks along +z.

    kinds: 'straight' | 'arc' (gentle yaw) | 'loop' (returns near start)
    | 'loop2' (TWO laps of the same circle — the second lap continuously
    revisits the first, giving multiple independent loop-closure
    windows on one clip).
    """
    if kind == "straight":
        yaw_rate = 0.0
    elif kind == "arc":
        yaw_rate = 0.002
    elif kind == "loop":
        yaw_rate = 2.0 * np.pi / max(n_frames - 1, 1)
    elif kind == "loop2":
        yaw_rate = 4.0 * np.pi / max(n_frames - 1, 1)
    else:
        raise ValueError(f"unknown trajectory kind: {kind}")
    xi = jnp.tile(
        jnp.array([0.0, 0.0, speed, 0.0, yaw_rate, 0.0], dtype),
        (n_frames - 1, 1))
    step = se3.exp_se3(xi)  # (F-1,4,4)

    def scan_fn(T, dT):
        T2 = T @ dT
        return T2, T2

    T0 = jnp.eye(4, dtype=dtype)
    _, rest = jax.lax.scan(scan_fn, T0, step)
    return jnp.concatenate([T0[None], rest], axis=0)


def make_world(key, n_frames: int = 64, n_points: int = 4096,
               trajectory: str = "arc", speed: float = 1.0,
               cam: StereoCamera | None = None,
               image_hw: tuple | None = None,
               patch_size: int = 15, z_range: tuple | None = None,
               dtype=jnp.float32) -> SyntheticWorld:
    """image_hw: if given (and cam is not), the camera is rescaled to
    that canvas so rendered landmarks actually fall inside it.

    z_range: depth band of the landmarks relative to their anchor
    frame. Defaults to (6, 55) m at full resolution; for LOW-RES test
    canvases (image_hw given) it defaults to a NARROWER (9, 34) m: a
    low-focal camera renders the 6-55 m band as 2-4 px star-field
    stamps whose surroundings shift by several px of differential
    disparity between the stereo views — locally view-dependent imagery
    no descriptor can match reliably. The narrow band keeps stamps
    resolvable and their context stereo-consistent at test scale."""
    if cam is None:
        cam = (StereoCamera.for_canvas(*image_hw, dtype) if image_hw
               else StereoCamera.kitti_default(dtype))
        if image_hw and z_range is None:
            z_range = (9.0, 34.0)
    if z_range is None:
        z_range = (6.0, 55.0)
    poses = make_trajectory(n_frames, trajectory, speed, dtype)
    k1, k2, k3 = jax.random.split(key, 3)
    # Anchor each landmark to a random frame's frustum so the whole
    # trajectory stays covered.
    anchor = jax.random.randint(k1, (n_points,), 0, n_frames)
    local = jnp.stack([
        jax.random.uniform(k2, (n_points,), dtype, -18.0, 18.0),
        jax.random.uniform(jax.random.fold_in(k2, 1), (n_points,), dtype,
                           -4.0, 3.0),
        jax.random.uniform(jax.random.fold_in(k2, 2), (n_points,), dtype,
                           z_range[0], z_range[1]),
    ], axis=-1)
    T = poses[anchor]                                   # (P,4,4)
    pts = (T[:, :3, :3] @ local[..., None])[..., 0] + T[:, :3, 3]
    # High-contrast random texture per landmark; centre boosted so FAST
    # has a strong nucleus. Geometric consistency of the OFF-centre
    # texture corners (which detectors also lock onto) is provided by
    # the PERSPECTIVE-SCALED stamping in render_frame — each stamp
    # behaves like a small fronto-parallel surface patch, so every
    # texture corner is a valid virtual 3D point under parallax.
    # patch_size sets the texture RESOLUTION only (the rendered extent
    # is fixed by render_frame's perspective model): 15x15 texture for
    # a typically ~9 px stamp means most depths render in MINIFICATION,
    # keeping the stamp's internal structure sharp — each feature then
    # carries its own orientation signal (a 9x9 texture magnified
    # bilinearly washed out to near-symmetric blobs whose
    # intensity-centroid orientation was dominated by neighbouring
    # stamps, diverging ~19-48 deg between stereo views and collapsing
    # the match rate).
    # BAND-LIMITED texture (random control grid bilinearly upsampled):
    # per-texel white noise point-sampled at minification stride ~2
    # DECORRELATES between the two stereo views' sub-pixel sampling
    # phases — the same stamp renders as different noise in L and R and
    # matching collapses. A ~2-texel-wavelength texture survives
    # bilinear resampling coherently at any phase.
    half = (patch_size + 1) // 2 + 1
    base = jax.random.uniform(k3, (n_points, half, half), dtype,
                              0.25, 1.0)
    patches = jax.image.resize(base, (n_points, patch_size, patch_size),
                               "linear")
    c = patch_size // 2
    # Per-landmark shading DIPOLE: a linear intensity gradient in a
    # random direction. The steered-BRIEF orientation is an intensity
    # centroid; for a zero-mean noise texture that is a ratio of two
    # near-zero moments — so ill-conditioned that the angle diverged
    # 17-48 deg between the two stereo views of the SAME stamp,
    # rotating the descriptor pattern and collapsing the match rate.
    # Real-world corners carry gradient asymmetry; the dipole gives
    # each synthetic landmark the same property, making orientation
    # strong, landmark-intrinsic, and view-consistent.
    ang = jax.random.uniform(jax.random.fold_in(k3, 7), (n_points, 1, 1),
                             dtype, 0.0, 2.0 * jnp.pi)
    yy = (jnp.arange(patch_size, dtype=dtype) - c) / max(c, 1)
    shade = 1.0 + 0.5 * (jnp.cos(ang) * yy[None, None, :]
                         + jnp.sin(ang) * yy[None, :, None])
    patches = jnp.clip(patches * shade, 0.05, 1.0)
    patches = patches.at[:, c, c].set(1.0)
    return SyntheticWorld(pts, patches, poses, cam)


@functools.partial(jax.jit, static_argnums=(2, 3))
def render_frame(world: SyntheticWorld, frame_idx, height: int, width: int):
    """Render the rectified stereo pair for one frame.

    Returns (left, right) float32 (H,W) images in [0,1].
    """
    T_wc = world.poses[frame_idx]
    X_cam = se3.transform_points(se3.inverse(T_wc), world.points)
    uv_l, uv_r, in_front = project_stereo(world.cam, X_cam)
    z = X_cam[..., 2]
    vis = in_front & (z > 2.0) & (z < 90.0)

    # Compact to the visible subset (static top-k budget): the splat
    # scatter would otherwise pay for EVERY point while only a few % are
    # in the frustum of any one frame. 6144 slots cover the densest frames with a wide margin;
    # truly hidden points carry vis=False and splat nothing either way.
    P = world.points.shape[0]
    K = min(P, 6144)
    patches = world.patches
    if K < P:
        _, sel = jax.lax.top_k(vis.astype(jnp.float32), K)
        uv_l = uv_l[sel]
        uv_r = uv_r[sel]
        vis = vis[sel]
        patches = world.patches[sel]

    ps = world.patches.shape[-1]
    r = ps // 2
    # PERSPECTIVE-SCALED stamping: the stamp extent scales with
    # Z_REF / z, so each stamp behaves like a small FRONTO-PARALLEL
    # SURFACE PATCH at the landmark's depth. A constant-pixel-size
    # billboard (the earlier design) is geometrically inconsistent
    # under parallax: a texture corner 4 px off-centre moves with the
    # patch CENTRE's flow instead of a real 3D point's, which put a
    # systematic ~4 px error field under the detector and a -2.7%
    # yaw-rate bias / ~2%/m drift under the whole VO stack. With
    # perspective scaling every texture corner is a consistent virtual
    # 3D point on the patch plane (correct stereo disparity AND
    # correct parallax to first order), so sub-pixel feature work
    # actually pays off.
    # Stamps model a fixed-size world surface patch: pixel extent
    # proportional to fx / z, normalized so a KITTI-focal camera
    # (fx ~ 718) renders scale 1 at 18 m. Scaling by fx keeps the
    # scene LOOKING the same across canvas resolutions — with a fixed
    # pixel size, a small test canvas drowns in overlapping stamps
    # whose max-blend intersections are non-repeatable pseudo-corners
    # (measured: L-R match rate collapsed 192 -> 41 on the 128x256
    # test canvas).
    # The fx ratio is floored: a LOW-RES camera of the same FOV
    # genuinely resolves less texture, but letting stamps shrink to
    # ~2 px starves the 13-px rBRIEF support of context (measured on
    # the 128x256 test canvas: L-R match rate 26/191) — the floor keeps
    # test-scale canvases feature-rich while full-resolution rendering
    # (fx ~ 718) is exactly perspective-true.
    Z_REF = 18.0 * jnp.clip(world.cam.fx / 718.0, 0.8, 1.0)
    EXT_REF = 9.0                 # rendered stamp extent (px) at Z_REF
    # Canvas half-extent: bounds magnification (points nearer than
    # ~10 m render with an edge-truncated stamp) AND the splat's
    # intermediate footprint — (batch, K, cs, cs) gather/blend arrays,
    # ~0.5 GB transient at cs=25; cs=19 keeps it small.
    R_CAN = 9
    dy = jnp.arange(-R_CAN, R_CAN + 1)
    oy, ox = jnp.meshgrid(dy, dy, indexing="ij")   # (cs,cs)

    zc = jnp.maximum(X_cam[..., 2], 1e-3)
    if K < P:
        zc = zc[sel]

    def splat(uv, valid):
        cx = jnp.round(uv[..., 0]).astype(jnp.int32)
        cy = jnp.round(uv[..., 1]).astype(jnp.int32)
        fx_ = uv[..., 0] - cx.astype(uv.dtype)      # in [-0.5, 0.5]
        fy_ = uv[..., 1] - cy.astype(uv.dtype)
        # Rendered extent = EXT_REF * Z_REF / z px, clamped: the floor
        # (~2 px) only guards the unresolvable tail — at KITTI focal
        # length the WHOLE visible range (< 90 m) renders
        # perspective-true; the ceiling bounds magnification to the
        # canvas. (An earlier floor at 36 m re-billboarded every far
        # point; far points dominate rotation estimation, and their
        # inconsistent flow alone caused a -2% yaw-rate bias = the
        # dominant VO drift term at 2000-frame scale. Measured after
        # unclamping: +0.6% yaw bias, per-220-frame error 3.5 -> 1.8 m.)
        extent = jnp.clip(EXT_REF * Z_REF / zc, 2.0, 2.0 * R_CAN - 2.0)
        s = extent / ps                              # (K,) texture scale
        # Texture coordinate of each canvas pixel: the stamp is the
        # texture magnified by s and shifted by the sub-pixel fraction.
        ty = (oy[None] - fy_[:, None, None]) / s[:, None, None] + r
        tx = (ox[None] - fx_[:, None, None]) / s[:, None, None] + r
        iy = jnp.floor(ty).astype(jnp.int32)
        ix = jnp.floor(tx).astype(jnp.int32)
        wy = ty - iy
        wx = tx - ix
        inside = ((ty >= 0) & (ty <= ps - 1) & (tx >= 0) & (tx <= ps - 1))
        p = jnp.pad(patches, ((0, 0), (1, 2), (1, 2)))
        rows = jnp.arange(p.shape[0])[:, None, None]
        iy1 = jnp.clip(iy + 1, 0, ps + 1)
        ix1 = jnp.clip(ix + 1, 0, ps + 1)
        v00 = p[rows, iy1, ix1]
        v01 = p[rows, iy1, ix1 + 1]
        v10 = p[rows, iy1 + 1, ix1]
        v11 = p[rows, iy1 + 1, ix1 + 1]
        vals = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
                + v10 * wy * (1 - wx) + v11 * wy * wx)
        vals = jnp.where(inside, vals, 0.0)

        inb = valid & (cx >= R_CAN) & (cx < width - R_CAN) \
            & (cy >= R_CAN) & (cy < height - R_CAN)
        yy = cy[:, None, None] + oy[None]
        xx = cx[:, None, None] + ox[None]
        vals = jnp.where(inb[:, None, None], vals, 0.0)
        yy = jnp.clip(yy, 0, height - 1)
        xx = jnp.clip(xx, 0, width - 1)
        img = jnp.zeros((height, width), world.points.dtype)
        # `max` rather than `add` so overlapping patches stay in [0,1]
        # and the texture is stable under partial occlusion.
        return img.at[yy, xx].max(vals)

    return splat(uv_l, vis), splat(uv_r, vis)


def render_sequence(world: SyntheticWorld, height: int, width: int,
                    batch_size: int = 8):
    """(F,H,W) left and right stacks (device arrays).

    Renders in `batch_size`-frame chunks (lax.map scans over chunks,
    vmapping within each): a flat vmap over all F frames materializes
    the (F, P, ps, ps) splat intermediates at once — ~30 GB for a
    300-frame / 12k-point world.
    """
    f = lambda i: render_frame(world, i, height, width)
    return jax.lax.map(f, jnp.arange(world.poses.shape[0]),
                       batch_size=batch_size)


def make_ba_problem(seed: int, n_cams: int = 1000, n_points: int = 34000,
                    capacity: int = 1 << 17, views: int = 6,
                    px_noise: float = 0.5):
    """A seeded global-BA problem shaped like a long drive's keyframe map.

    `n_cams` keyframes on a one-lap loop at 1 m per keyframe; each
    landmark is anchored in a random keyframe's frustum and observed in
    stereo by that keyframe and the next `views - 1` while it projects
    inside the KITTI image. The defaults give about 170k observations
    over 1000 keyframes in a 2^17-landmark table, the size of the
    global BA over a 2000-frame run at a keyframe every second frame.
    Landmarks sit at random rows of the table, as in a map whose culled
    rows have been reused. Initial poses carry 1 cm / 10 mrad noise
    (keyframe 0 exact: the gauge), points 0.1 m.

    Returns (BAProblem, (n_cams,4,4) ground-truth poses, camera).
    """
    from slam1_tpu.models.ba import make_problem

    rng = np.random.default_rng(seed)
    cam = StereoCamera.kitti_default()
    fx, fy, cx, cy, b = (float(np.asarray(v)) for v in (
        cam.fx, cam.fy, cam.cx, cam.cy, cam.baseline))
    poses = np.asarray(make_trajectory(n_cams, "loop"), np.float64)
    anchor = rng.integers(0, n_cams, n_points)
    local = np.stack([rng.uniform(-15, 15, n_points),
                      rng.uniform(-3, 3, n_points),
                      rng.uniform(8, 40, n_points)], -1)
    pts = (np.einsum("pij,pj->pi", poses[anchor, :3, :3], local)
           + poses[anchor, :3, 3])
    ci = anchor[:, None] + np.arange(views)[None, :]            # (P,V)
    ok = ci < n_cams
    ci = np.minimum(ci, n_cams - 1)
    inv = np.linalg.inv(poses)[ci]                               # (P,V,4,4)
    xc = (np.einsum("pvij,pj->pvi", inv[..., :3, :3], pts)
          + inv[..., :3, 3])
    z = np.maximum(xc[..., 2], 1e-3)
    u = fx * xc[..., 0] / z + cx
    v = fy * xc[..., 1] / z + cy
    ur = fx * (xc[..., 0] - b) / z + cx
    ok &= ((xc[..., 2] > 1.0) & (u > 0) & (u < 1226) & (v > 0) & (v < 370)
           & (ur > 0))
    lm_row = rng.permutation(capacity)[:n_points]
    p_idx, v_idx = np.nonzero(ok)
    n_obs = p_idx.size
    uv = np.stack([u[p_idx, v_idx], v[p_idx, v_idx]], -1)
    uv += rng.normal(0, px_noise, uv.shape)
    urs = ur[p_idx, v_idx] + rng.normal(0, px_noise, n_obs)

    dpose = rng.normal(0, 0.01, (n_cams, 6))
    dpose[0] = 0.0
    init = poses @ np.asarray(se3.exp_se3(jnp.asarray(dpose, jnp.float32)))
    table = np.zeros((capacity, 3))
    table[lm_row] = pts + rng.normal(0, 0.1, pts.shape)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    prob = make_problem(
        poses=f32(init), points=f32(table),
        cam_idx=jnp.asarray(ci[p_idx, v_idx], jnp.int32),
        lm_idx=jnp.asarray(lm_row[p_idx], jnp.int32), uv=f32(uv),
        w=jnp.ones(n_obs, jnp.float32), ur=f32(urs),
        wr=jnp.ones(n_obs, jnp.float32))
    return prob, f32(poses), cam


def noisy_pose_chain(f: int, seed: int = 7):
    """Drifty circle trajectory for pose-graph tests: (gt (f,4,4), odometry
    estimate (f,4,4), edge measurements z (f,4,4), edge weights w (f,),
    fixed-capacity loop edges (le_i, le_j, le_z, le_w) holding one true
    first-to-last edge). Odometry twists carry N(0, 0.004) noise."""
    t = np.linspace(0, 2 * np.pi * (f - 1) / f, f)
    gt = np.tile(np.eye(4, dtype=np.float32), (f, 1, 1))
    gt[:, 0, 3] = 20.0 * np.sin(t)
    gt[:, 2, 3] = 20.0 * (1 - np.cos(t))
    for k in range(f):
        c, s = np.cos(t[k]), np.sin(t[k])
        gt[k, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                                 np.float32)
    rng = np.random.default_rng(seed)
    xi = np.asarray(se3.log_se3(jnp.asarray(
        np.linalg.inv(gt[:-1]) @ gt[1:])))
    xi = xi + rng.normal(0, 0.004, xi.shape).astype(np.float32)
    z = np.tile(np.eye(4, dtype=np.float32), (f, 1, 1))
    z[:-1] = np.asarray(se3.exp_se3(jnp.asarray(xi)))
    w = np.zeros((f,), np.float32)
    w[:-1] = 1.0
    est = np.tile(np.eye(4, dtype=np.float32), (f, 1, 1))
    for k in range(f - 1):
        est[k + 1] = est[k] @ z[k]
    n_loop = 4
    le_i = np.zeros(n_loop, np.int32)
    le_j = np.zeros(n_loop, np.int32)
    le_z = np.tile(np.eye(4, dtype=np.float32), (n_loop, 1, 1))
    le_w = np.zeros(n_loop, np.float32)
    le_i[0], le_j[0] = 0, f - 1
    le_z[0] = np.linalg.inv(gt[0]) @ gt[f - 1]
    le_w[0] = 5.0
    return gt, est, z, w, (le_i, le_j, le_z, le_w)
