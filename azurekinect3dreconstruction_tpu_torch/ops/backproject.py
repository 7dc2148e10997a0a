"""Depth -> organized point map, pinhole projection and image samplers.

The counterparts of the JAX package's ``ops/backproject.py``: the organized
``(H, W, ...)`` layout is kept, since projective ICP and image-space normals
rely on it; ``flatten_organized`` turns it into the fixed-capacity
:class:`..core.types.PointCloud`. Out-of-bounds samples are invalid
(masked), not clamped.
"""

from __future__ import annotations

from typing import Optional

import torch

from azurekinect3dreconstruction_tpu_torch.core.camera import Distortion, Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu_torch.core.fmath import fma
from azurekinect3dreconstruction_tpu_torch.core.types import PointCloud


def backproject_depth(depth, rays):
    """(H, W) depth [m] x (H, W, 2) ray table -> (H, W, 3) camera-space
    points; invalid pixels (depth == 0) give (0, 0, 0)."""
    return torch.cat([rays * depth[..., None], depth[..., None]], dim=-1)


def backproject_intrinsics(depth, intr: Intrinsics, distortion: Optional[Distortion] = None):
    """:func:`backproject_depth` with the ray table built on the fly."""
    return backproject_depth(depth, pixel_rays(intr, depth.device, distortion))


def flatten_organized(points, mask, colors=None, normals=None) -> PointCloud:
    """(H, W, 3) organized maps -> fixed-capacity flat cloud (N = H*W)."""
    h, w = points.shape[:2]
    flat = lambda a: None if a is None else a.reshape(h * w, -1)
    return PointCloud(points=flat(points), mask=mask.reshape(h * w), colors=flat(colors),
                      normals=flat(normals))


def project_points(points, intr: Intrinsics):
    """Camera-space (..., 3) points -> pixel coords (..., 2) and z (...,)."""
    z = points[..., 2]
    safe_z = torch.where(z.abs() > 1e-9, z, 1e-9)
    u = fma(points[..., 0] / safe_z, intr.fx, intr.cx)
    v = fma(points[..., 1] / safe_z, intr.fy, intr.cy)
    return torch.stack([u, v], dim=-1), z


def bilinear_sample(img, uv, valid_fill: float = 0.0):
    """Bilinear interpolation of (H, W) or (H, W, C) ``img`` at float pixel
    coords ``uv`` (..., 2). Returns (values, in_bounds); in bounds means the
    whole 2x2 stencil is inside: ``0 <= u0 < W-1`` and ``0 <= v0 < H-1``."""
    h, w = img.shape[:2]
    u, v = uv[..., 0], uv[..., 1]
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0
    # float -> int truncates toward zero as jnp's astype does; out-of-range
    # values fail the bounds test either way
    u0i, v0i = u0.to(torch.int64), v0.to(torch.int64)
    inb = (u0i >= 0) & (v0i >= 0) & (u0i < w - 1) & (v0i < h - 1)
    u0c, v0c = torch.clamp(u0i, 0, w - 2), torch.clamp(v0i, 0, h - 2)
    c00, c01 = img[v0c, u0c], img[v0c, u0c + 1]
    c10, c11 = img[v0c + 1, u0c], img[v0c + 1, u0c + 1]
    if img.ndim == 3:
        du, dv, inb_v = du[..., None], dv[..., None], inb[..., None]
    else:
        inb_v = inb
    val = (c00 * (1 - du) * (1 - dv) + c01 * du * (1 - dv)
           + c10 * (1 - du) * dv + c11 * du * dv)
    return torch.where(inb_v, val, valid_fill), inb


def nearest_sample(img, uv):
    """Nearest-pixel sample (for depth and normals, where bilinear blends
    across edges); coordinates round half to even, as ``jnp.round`` does."""
    h, w = img.shape[:2]
    ui = torch.round(uv[..., 0]).to(torch.int64)
    vi = torch.round(uv[..., 1]).to(torch.int64)
    inb = (ui >= 0) & (vi >= 0) & (ui < w) & (vi < h)
    val = img[torch.clamp(vi, 0, h - 1), torch.clamp(ui, 0, w - 1)]
    return torch.where(inb[..., None] if img.ndim == 3 else inb, val, 0.0), inb
