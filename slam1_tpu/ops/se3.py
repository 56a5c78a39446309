"""SO(3)/SE(3) Lie-group operations, batched and jit-friendly.

Replaces the reference's cv2.Rodrigues + ad-hoc 4x4 assembly
(/root/reference/transformation.py:23-56) and the Euler helpers it never
uses. Everything here is pure jnp, differentiable, and vmaps over leading
batch dimensions, which is what the vmapped-RANSAC and batched-BA layers
build on.

Conventions:
  - Rotations are 3x3 matrices R, twists are (6,) vectors [rho, phi]
    (translation first, rotation last) matching the tangent of
    T = [[R, t], [0, 1]].
  - `exp_se3` uses the closed-form V matrix so t = V @ rho.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def hat(w):
    """(...,3) -> (...,3,3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy], axis=-1),
        jnp.stack([wz, z, -wx], axis=-1),
        jnp.stack([-wy, wx, z], axis=-1),
    ], axis=-2)


def vee(W):
    """(...,3,3) skew -> (...,3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _safe_theta(phi):
    """Gradient-safe rotation angle: (theta, theta2, small_mask), each
    shaped (...,1,1). The double-where trick keeps d(sqrt)/d(phi) finite
    at phi = 0 — critical because RANSAC/BA jacfwd through exp at the
    zero perturbation."""
    th2 = jnp.sum(phi * phi, axis=-1, keepdims=True)[..., None]
    small = th2 < 1e-8
    theta = jnp.sqrt(jnp.where(small, 1.0, th2))
    return theta, th2, small


def exp_so3(phi):
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation matrix."""
    theta, th2, small = _safe_theta(phi)
    K = hat(phi)
    K2 = K @ K
    # Taylor-safe coefficients sin(t)/t and (1-cos t)/t^2.
    a = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - th2 / 24.0, (1.0 - jnp.cos(theta)) / th2)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + a * K + b * K2


def log_so3(R):
    """(...,3,3) rotation -> (...,3) axis-angle (gradient-safe at I)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5  # = sin(theta) * axis
    # sin(theta) from |w| with a safe sqrt; theta via atan2 (finite
    # derivatives at theta = 0, unlike arccos).
    s2 = jnp.sum(w * w, axis=-1, keepdims=True)
    small = (s2 < 1e-10) & (cos_t[..., None] > 0.0)
    sin_t = jnp.sqrt(jnp.where(small, 1.0, s2))
    theta = jnp.arctan2(sin_t, cos_t[..., None])
    near_pi = cos_t[..., None] < -0.999995
    scale = jnp.where(small, 1.0 + s2 / 6.0, theta / sin_t)
    generic = w * scale
    # theta ~ pi: axis from diagonal of (R + I)/2 = axis axis^T (1-cos)=2aa^T-...
    B = (R + jnp.eye(3, dtype=R.dtype)) * 0.5
    diag = jnp.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], axis=-1)
    axis = jnp.sqrt(jnp.clip(diag, 0.0, 1.0))
    # Fix signs using off-diagonals.
    sx = jnp.where(B[..., 0, 1] + B[..., 1, 0] >= 0, 1.0, -1.0)
    sz = jnp.where(B[..., 1, 2] + B[..., 2, 1] >= 0, 1.0, -1.0)
    axis = axis * jnp.stack([jnp.ones_like(sx), sx, sx * sz], axis=-1)
    axis = axis / (jnp.linalg.norm(axis, axis=-1, keepdims=True) + _EPS)
    return jnp.where(near_pi, axis * theta, generic)


def _v_matrix(phi):
    """Left Jacobian V of SE(3) exp: t = V @ rho (gradient-safe at 0)."""
    theta, th2, small = _safe_theta(phi)
    K = hat(phi)
    K2 = K @ K
    b = jnp.where(small, 0.5 - th2 / 24.0, (1.0 - jnp.cos(theta)) / th2)
    c = jnp.where(small, 1.0 / 6.0 - th2 / 120.0,
                  (theta - jnp.sin(theta)) / (th2 * theta))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + b * K + c * K2


def exp_se3(xi):
    """(...,6) twist [rho, phi] -> (...,4,4) transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = exp_so3(phi)
    t = (_v_matrix(phi) @ rho[..., None])[..., 0]
    return from_Rt(R, t)


def log_se3(T):
    """(...,4,4) -> (...,6) twist [rho, phi]."""
    from slam1_tpu.ops.lsq import inv3x3
    R, t = to_Rt(T)
    phi = log_so3(R)
    V = _v_matrix(phi)
    # closed-form 3x3 inverse instead of jnp.linalg.solve's LU
    rho = (inv3x3(V) @ t[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


def from_Rt(R, t):
    """(...,3,3),(...,3) -> (...,4,4)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (1, 4))
    return jnp.concatenate([top, bottom], axis=-2)


def to_Rt(T):
    return T[..., :3, :3], T[..., :3, 3]


def inverse(T):
    """(...,4,4) SE(3) inverse without a general solve."""
    R, t = to_Rt(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return from_Rt(Rt, -(Rt @ t[..., None])[..., 0])


def compose(A, B):
    return A @ B


def transform_points(T, X):
    """Apply (...,4,4) to points (...,N,3) -> (...,N,3)."""
    R, t = to_Rt(T)
    return X @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def rotation_angle(R):
    """Geodesic angle of a rotation matrix, radians."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return jnp.arccos(jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0))


def orthonormalize(R):
    """Project a near-rotation onto SO(3) via SVD (batched)."""
    U, _, Vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(U @ Vt)
    fix = jnp.concatenate(
        [jnp.ones_like(det)[..., None], jnp.ones_like(det)[..., None],
         det[..., None]], axis=-1)
    return (U * fix[..., None, :]) @ Vt
