"""SE(3) rigid-transform utilities on float32 torch tensors.

One convention everywhere, as in the JAX package: a pose ``T`` is the 4x4
**camera-to-world** matrix (``X_world = T @ X_cam``); twists are ordered
(vx, vy, vz, wx, wy, wz), translation first.

The 3x3 products that feed pixel projection (:func:`inverse`,
:func:`transform_points`) are written as an explicit chain of fused
multiply-adds instead of ``matmul``: a rounding difference there can move a
voxel across a half-pixel edge. The chain ``fma(z, R2, fma(y, R1, x R0)) + t``
is what the JAX package's compiled ``matmul`` computes on the CPU, and what
the CUDA integrate kernel computes (see :mod:`.fmath`).
"""

from __future__ import annotations

import torch

from azurekinect3dreconstruction_tpu_torch.core.fmath import fma


def hat(w):
    """3-vector -> skew-symmetric matrix, so that hat(w) @ v == cross(w, v)."""
    z = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack([
        torch.stack([z, -w[2], w[1]]),
        torch.stack([w[2], z, -w[0]]),
        torch.stack([-w[1], w[0], z]),
    ])


def _series_coeffs(theta2):
    """sin(t)/t, (1-cos t)/t^2 and (t - sin t)/t^3 with series fallbacks."""
    theta = torch.sqrt(theta2 + 1e-32)
    big = theta2 > 1e-6
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / torch.clamp_min(theta2, 1e-32),
                    0.5 - theta2 / 24.0)
    c = torch.where(big, (theta - torch.sin(theta)) / torch.clamp_min(theta2 * theta, 1e-32),
                    1.0 / 6.0 - theta2 / 120.0)
    return a, b, c


def so3_exp(w):
    """Rodrigues: axis-angle 3-vector -> rotation matrix. Taylor-safe at 0."""
    a, b, _ = _series_coeffs(torch.sum(w * w))
    W = hat(w)
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * W + b * (W @ W)


def so3_log(R):
    """Rotation matrix -> axis-angle 3-vector (principal branch)."""
    cos_t = torch.clamp((torch.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    v = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    # atan2 stays well-conditioned at small angles, where arccos(trace)
    # would round theta^2 out of the f32 trace entirely
    sin_t = 0.5 * torch.sqrt(torch.sum(v * v) + 1e-38)
    theta = torch.atan2(sin_t, cos_t)
    scale = torch.where(sin_t > 1e-6, theta / (2.0 * sin_t + 1e-32),
                        0.5 + theta * theta / 12.0)
    w_generic = scale * v
    # near theta == pi the vee part vanishes: recover the axis from the diagonal
    axis = torch.sqrt(torch.clamp((torch.diagonal(R) + 1.0) * 0.5, 0.0, 1.0))
    axis = axis * torch.where(v >= 0, 1.0, -1.0).to(R.dtype)
    return torch.where(theta > 3.1, axis * theta, w_generic)


def se3_exp(xi):
    """Twist (vx, vy, vz, wx, wy, wz) -> 4x4 transform."""
    v, w = xi[:3], xi[3:]
    _, b, c = _series_coeffs(torch.sum(w * w))
    W = hat(w)
    V = torch.eye(3, dtype=xi.dtype, device=xi.device) + b * W + c * (W @ W)
    T = torch.eye(4, dtype=xi.dtype, device=xi.device)
    T[:3, :3] = so3_exp(w)
    T[:3, 3] = V @ v
    return T


def se3_log(T):
    """4x4 transform -> twist (vx, vy, vz, wx, wy, wz)."""
    w = so3_log(T[:3, :3])
    theta2 = torch.sum(w * w)
    theta = torch.sqrt(theta2 + 1e-32)
    W = hat(w)
    A = torch.sin(theta) / torch.clamp_min(theta, 1e-32)
    B = (1.0 - torch.cos(theta)) / torch.clamp_min(theta2, 1e-32)
    coef = torch.where(theta2 > 1e-6,
                       (1.0 - A / torch.clamp_min(2.0 * B, 1e-32)) / torch.clamp_min(theta2, 1e-32),
                       1.0 / 12.0 + theta2 / 720.0)
    Vinv = torch.eye(3, dtype=T.dtype, device=T.device) - 0.5 * W + coef * (W @ W)
    return torch.cat([Vinv @ T[:3, 3], w])


def inverse(T):
    """Rigid inverse: [R t]^-1 = [R^T, -R^T t]."""
    Rt = T[:3, :3].T
    t = T[:3, 3]
    out = torch.eye(4, dtype=T.dtype, device=T.device)
    out[:3, :3] = Rt
    out[:3, 3] = -fma(Rt[:, 2], t[2], fma(Rt[:, 1], t[1], Rt[:, 0] * t[0]))
    return out


def compose_renormalized(T_a, T_b):
    """``T_a @ T_b`` in float32 with the rotation snapped back to SO(3) by
    one Newton step of the polar decomposition (R <- 1.5 R - 0.5 R R^T R).

    Rotation non-orthogonality compounds multiplicatively through a long f32
    pose chain; one step from a near-orthogonal start lands at roundoff."""
    T = T_a.to(torch.float32) @ T_b.to(torch.float32)
    R = T[:3, :3]
    T[:3, :3] = 1.5 * R - 0.5 * (R @ (R.T @ R))
    return T


def transform_points(T, pts):
    """Apply a 4x4 to (..., 3) float32 points: fma(z, R2, fma(y, R1, x R0)) + t."""
    R, t = T[:3, :3], T[:3, 3]
    acc = fma(pts[..., 1:2], R[:, 1], pts[..., 0:1] * R[:, 0])
    return fma(pts[..., 2:3], R[:, 2], acc) + t
