"""Frame container, the raw-sensor decode shared by every entry point, the
fixed-capacity point cloud, and the mesh and point-cloud containers of
extraction and saving."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device


def _f32(x) -> float:
    """A Python float holding exactly the float32 nearest ``x``: torch then
    multiplies and compares in f32 against the same constant the JAX
    package uses."""
    return float(np.float32(x))


def decode_raw_frame(depth_raw, color_raw, inv_scale, depth_min, depth_trunc):
    """Raw sensor arrays -> (depth m (H,W), color [0,1] (H,W,3), intensity (H,W)).

    ``depth_raw``: (H, W) uint16 (or any integer) tensor in native units;
    ``color_raw``: (H, W, 3) uint8 RGB, or float in [0, 1].

    Depth scales by a float32 reciprocal *multiply*, and the u8 luma is
    computed in exact integers and scaled once, so the result is bit-equal
    to the JAX package's decode."""
    if depth_raw.dtype == torch.uint16:
        # widen through the same-width signed view: every backend converts int16
        depth_raw = depth_raw.view(torch.int16).to(torch.int32) & 0xFFFF
    d = depth_raw.to(torch.float32) * _f32(inv_scale)
    d = torch.where((d > _f32(depth_min)) & (d < _f32(depth_trunc)), d, 0.0)
    c = color_raw.to(torch.float32)
    if color_raw.dtype == torch.uint8:
        c = c * _f32(1.0 / 255.0)
        ci = color_raw.to(torch.int32)
        luma = 299 * ci[..., 0] + 587 * ci[..., 1] + 114 * ci[..., 2]
        intensity = luma.to(torch.float32) * _f32(1.0 / 255000.0)
    else:
        intensity = 0.299 * c[..., 0] + 0.587 * c[..., 1] + 0.114 * c[..., 2]
    return d, torch.clamp(c, 0.0, 1.0), intensity


@dataclasses.dataclass
class RGBDFrame:
    """One registered RGB-D frame in the depth camera's geometry.

    depth: (H, W) float32 meters, 0 where invalid; color: (H, W, 3) float32
    in [0, 1]; intensity: (H, W) float32 grayscale (for odometry)."""

    depth: torch.Tensor
    color: torch.Tensor
    intensity: torch.Tensor

    @staticmethod
    def from_raw(depth_raw, color, depth_scale: float = 1000.0, depth_trunc: float = 3.0,
                 depth_min: float = 0.1) -> "RGBDFrame":
        """Build from raw sensor tensors: integer depth in native units + u8
        RGB (float color is clipped to [0, 1] before the luma)."""
        if color.dtype != torch.uint8:
            color = torch.clamp(color.to(torch.float32), 0.0, 1.0)
        return RGBDFrame(*decode_raw_frame(depth_raw, color, 1.0 / depth_scale,
                                           depth_min, depth_trunc))

    @property
    def valid(self) -> torch.Tensor:
        """(H, W) bool: where the frame has depth."""
        return self.depth > 0.0


def _host(a) -> Optional[np.ndarray]:
    """A tensor or array as a host numpy array (``None`` stays ``None``)."""
    if a is None or isinstance(a, np.ndarray):
        return a
    return a.detach().cpu().numpy()


@dataclasses.dataclass
class PointCloud:
    """Fixed-capacity point cloud on one device: points (N, 3) f32, mask
    (N,) bool, colors / normals (N, 3) f32 or None."""

    points: torch.Tensor
    mask: torch.Tensor
    colors: Optional[torch.Tensor] = None
    normals: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> torch.Tensor:
        """Live points, an int32 0-d tensor on the cloud's device."""
        return self.mask.to(torch.int32).sum(dtype=torch.int32)

    def compact(self) -> "PointCloudHost":
        """Host-side dense copy with the masked-off rows dropped."""
        m = _host(self.mask).astype(bool)
        cut = lambda a: None if a is None else _host(a)[m]
        return PointCloudHost(points=cut(self.points), colors=cut(self.colors),
                              normals=cut(self.normals))

    @staticmethod
    def from_numpy(points, colors=None, normals=None, capacity: Optional[int] = None, *,
                   device="cuda") -> "PointCloud":
        """Host arrays -> a cloud on ``device``, zero-padded to ``capacity``
        rows (default: the point count; ``ValueError`` if it is smaller)."""
        dev = resolve_device(device)
        points = np.asarray(points, dtype=np.float32)
        n = points.shape[0]
        cap = capacity or n
        if cap < n:
            raise ValueError(f"capacity {cap} < point count {n}")

        def pad(a):
            if a is None:
                return None
            out = np.zeros((cap, np.shape(a)[1]), dtype=np.float32)
            out[:n] = a
            return torch.from_numpy(out).to(dev)

        mask = np.zeros((cap,), dtype=bool)
        mask[:n] = True
        return PointCloud(points=pad(points), mask=torch.from_numpy(mask).to(dev),
                          colors=pad(colors), normals=pad(normals))


@dataclasses.dataclass
class PointCloudHost:
    """Plain-numpy compacted cloud for IO/viz."""

    points: np.ndarray
    colors: Optional[np.ndarray] = None
    normals: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(self.points.shape[0])


@dataclasses.dataclass
class TriangleMesh:
    """Triangle soup from marching cubes, possibly padded past its live
    counts (the JAX package's is padded to its budget).

    vertices: (V, 3) f32; vertex_colors: (V, 3) f32; triangles: (T, 3) i32;
    num_vertices / num_triangles: live counts; overflow: the budget was too
    small and the soup is truncated. The arrays may be numpy arrays or
    tensors; :meth:`compact` copies the live prefix to the host."""

    vertices: object
    triangles: object
    num_vertices: object
    num_triangles: object
    vertex_colors: object = None
    vertex_normals: object = None
    overflow: bool = False

    def compact(self) -> "TriangleMeshHost":
        nv = int(self.num_vertices)
        nt = int(self.num_triangles)
        cut = lambda a, n: None if a is None else _host(a[:n])
        return TriangleMeshHost(
            vertices=cut(self.vertices, nv),
            triangles=cut(self.triangles, nt),
            vertex_colors=cut(self.vertex_colors, nv),
            vertex_normals=cut(self.vertex_normals, nv),
        )


@dataclasses.dataclass
class TriangleMeshHost:
    """Plain-numpy indexed mesh (or compacted soup) for IO/viz."""

    vertices: np.ndarray
    triangles: np.ndarray
    vertex_colors: Optional[np.ndarray] = None
    vertex_normals: Optional[np.ndarray] = None

    def compact(self) -> "TriangleMeshHost":
        """Already compact: callers treat device and host meshes alike."""
        return self

    def compute_vertex_normals(self) -> "TriangleMeshHost":
        """Area-weighted vertex normals from the face cross products."""
        v, t = self.vertices, self.triangles
        fn = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
        vn = np.zeros_like(v)
        for k in range(3):
            np.add.at(vn, t[:, k], fn)
        norm = np.linalg.norm(vn, axis=1, keepdims=True)
        self.vertex_normals = vn / np.maximum(norm, 1e-12)
        return self
