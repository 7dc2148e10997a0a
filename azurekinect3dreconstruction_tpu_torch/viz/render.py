"""Preview rendering without GL or Open3D: z-buffered vertex splatting to
PNG (a copy of the JAX package's ``viz/render.py``, the same bytes for the
same mesh and arguments).

Vertices are projected and composited far to near, Lambert-shaded from
vertex normals. Marching-cubes triangle edges are at voxel scale, so at
preview resolutions vertex density matches or exceeds pixel density and
splatting looks like rasterization at a fraction of its cost. PNG encoding
is stdlib-only (zlib + struct).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from azurekinect3dreconstruction_tpu_torch.core.types import TriangleMeshHost


def write_png(path: str, rgb: np.ndarray) -> str:
    """Minimal RGB8 PNG writer (no deps)."""
    img = np.ascontiguousarray(rgb.astype(np.uint8))
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
    return path


def _orbit_pose(center: np.ndarray, radius: float, azimuth: float,
                elevation: float = 0.35) -> np.ndarray:
    """Camera-to-world pose looking at ``center`` from an orbit point."""
    eye = center + radius * np.array([
        np.sin(azimuth) * np.cos(elevation),
        -np.sin(elevation),
        -np.cos(azimuth) * np.cos(elevation),
    ])
    z = center - eye
    z = z / np.linalg.norm(z)
    up = np.array([0.0, -1.0, 0.0])
    x = np.cross(up, z)
    n = np.linalg.norm(x)
    x = x / n if n > 1e-9 else np.array([1.0, 0.0, 0.0])
    y = np.cross(z, x)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, eye
    return T


def render_points(points: np.ndarray, colors: Optional[np.ndarray],
                  T_world_cam: np.ndarray, size: Tuple[int, int] = (640, 480),
                  fov: float = 60.0, point_px: int = 2,
                  background=(18, 18, 24)) -> np.ndarray:
    """Z-buffered point splat -> (H, W, 3) u8. ``point_px`` splats each
    point as a point_px x point_px block so sparse clouds stay solid."""
    w, h = size
    f = 0.5 * w / np.tan(np.radians(fov) / 2)
    T_cw = np.linalg.inv(T_world_cam)
    pc = points @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = pc[:, 2]
    ok = z > 1e-6
    u = np.where(ok, pc[:, 0] / np.maximum(z, 1e-6) * f + w / 2, -1)
    v = np.where(ok, pc[:, 1] / np.maximum(z, 1e-6) * f + h / 2, -1)
    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    if colors is None:
        colors = np.full((len(points), 3), 0.8, np.float32)

    # painter's algorithm via ordering: duplicate fancy-index assignments
    # keep the LAST write, so ONE far-to-near-sorted assignment over all
    # splat offsets z-buffers for free (per-offset assignments would let a
    # later offset's far points overwrite an earlier offset's near points)
    offs = [(dx - point_px // 2, dy - point_px // 2)
            for dy in range(point_px) for dx in range(point_px)]
    k = len(offs)
    uu = (ui[None, :] + np.array([o[0] for o in offs])[:, None]).reshape(-1)
    vv = (vi[None, :] + np.array([o[1] for o in offs])[:, None]).reshape(-1)
    zz = np.broadcast_to(z, (k, len(z))).reshape(-1)
    src = np.broadcast_to(np.arange(len(z)), (k, len(z))).reshape(-1)
    m = (np.broadcast_to(ok, (k, len(z))).reshape(-1)
         & (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h))
    order = np.argsort(-zz[m], kind="stable")
    flat = (vv * w + uu)[m][order]
    idx = np.full((h * w,), -1, np.int64)
    idx[flat] = src[m][order]
    img = np.empty((h * w, 3), np.float32)
    img[:] = np.asarray(background, np.float32) / 255.0
    hit = idx >= 0
    img[hit] = colors[idx[hit]]
    return (np.clip(img, 0, 1).reshape(h, w, 3) * 255).astype(np.uint8)


def render_mesh(mesh: TriangleMeshHost, T_world_cam: Optional[np.ndarray] = None,
                size: Tuple[int, int] = (640, 480), fov: float = 60.0,
                light=(0.3, -0.5, -0.8), ambient: float = 0.35,
                point_px: int = 2) -> np.ndarray:
    """Lambert-shaded preview of a mesh (vertex splat; see module doc)."""
    v = np.asarray(mesh.vertices, np.float32)
    if mesh.vertex_normals is None:
        mesh.compute_vertex_normals()
    n = np.asarray(mesh.vertex_normals, np.float32)
    albedo = (np.asarray(mesh.vertex_colors, np.float32)
              if mesh.vertex_colors is not None
              else np.full_like(v, 0.75))
    l = np.asarray(light, np.float32)
    l = l / np.linalg.norm(l)
    # double-sided shading so backfacing normals don't go black
    lam = np.abs(n @ l)
    shade = np.clip(ambient + (1 - ambient) * lam, 0, 1)[:, None]
    if T_world_cam is None:
        center = 0.5 * (v.min(0) + v.max(0))
        radius = 1.6 * np.linalg.norm(v.max(0) - v.min(0)) / 2 + 1e-3
        T_world_cam = _orbit_pose(center, radius, 0.5)
    return render_points(v, albedo * shade, T_world_cam, size, fov,
                         point_px=point_px)


def save_mesh_preview(mesh: TriangleMeshHost, path: str, **kw) -> str:
    return write_png(path, render_mesh(mesh, **kw))


def save_turntable(mesh: TriangleMeshHost, path_prefix: str, n_views: int = 6,
                   size: Tuple[int, int] = (640, 480), **kw) -> list:
    """PNG orbit around the mesh: path_prefix_00.png ... _NN.png."""
    v = np.asarray(mesh.vertices, np.float32)
    center = 0.5 * (v.min(0) + v.max(0))
    radius = 1.6 * np.linalg.norm(v.max(0) - v.min(0)) / 2 + 1e-3
    out = []
    for i in range(n_views):
        T = _orbit_pose(center, radius, 2 * np.pi * i / n_views)
        img = render_mesh(mesh, T_world_cam=T, size=size, **kw)
        out.append(write_png(f"{path_prefix}_{i:02d}.png", img))
    return out
