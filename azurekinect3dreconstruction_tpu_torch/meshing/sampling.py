"""Uniform surface sampling of triangle meshes and save-time color transfer
(the counterparts of the JAX package's ``meshing/sampling.py``).

The fragment pipeline registers uniformly sampled mesh points with
point-to-point ICP, and the cloud accumulator paints a Poisson mesh from its
model cloud. Sampling is area-weighted host numpy, a copy of the JAX
package's: a triangle is picked with probability proportional to its area
and a point placed by uniform barycentric coordinates (the sqrt trick), so
the same mesh and seed give the same samples to the bit. Sampling picks
triangles by index: the same surface in another triangle order gives other
samples.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device
from azurekinect3dreconstruction_tpu_torch.core.types import PointCloudHost, TriangleMeshHost
from azurekinect3dreconstruction_tpu_torch.ops.neighbors import (
    auto_capacity,
    build_cell_lists,
    knn_gather,
)


def sample_points_uniformly(mesh: TriangleMeshHost, n: int = 100_000,
                            seed: Optional[int] = 0) -> PointCloudHost:
    """Area-uniform random samples on the mesh surface.

    Returns a PointCloudHost with interpolated colors/normals when the mesh
    carries them. ``seed=None`` uses nondeterministic entropy."""
    v = np.asarray(mesh.vertices, np.float64)
    t = np.asarray(mesh.triangles, np.int64)
    if len(t) == 0:
        return PointCloudHost(points=np.zeros((0, 3), np.float32))
    p0, p1, p2 = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    cross = np.cross(p1 - p0, p2 - p0)
    area = 0.5 * np.linalg.norm(cross, axis=1)
    total = area.sum()
    if total <= 0:
        return PointCloudHost(points=np.zeros((0, 3), np.float32))

    rng = np.random.default_rng(seed)
    tri = rng.choice(len(t), size=n, p=area / total)
    # uniform barycentric: u = 1-sqrt(r1), v = r2*sqrt(r1)
    r1 = np.sqrt(rng.random(n))
    r2 = rng.random(n)
    w0 = 1.0 - r1
    w1 = r1 * (1.0 - r2)
    w2 = r1 * r2

    def interp(attr):
        a0, a1, a2 = attr[t[tri, 0]], attr[t[tri, 1]], attr[t[tri, 2]]
        return (w0[:, None] * a0 + w1[:, None] * a1 + w2[:, None] * a2)

    pts = interp(v).astype(np.float32)
    colors = None
    if mesh.vertex_colors is not None:
        colors = interp(np.asarray(mesh.vertex_colors, np.float64)).astype(np.float32)
    normals = None
    if mesh.vertex_normals is not None:
        nrm = interp(np.asarray(mesh.vertex_normals, np.float64))
        nn = np.linalg.norm(nrm, axis=1, keepdims=True)
        normals = (nrm / np.maximum(nn, 1e-12)).astype(np.float32)
    return PointCloudHost(points=pts, colors=colors, normals=normals)


def transfer_colors(mesh: TriangleMeshHost, cloud: PointCloudHost, radius: float = 0.02, *,
                    device="cuda") -> TriangleMeshHost:
    """Color each mesh vertex from its nearest cloud point within
    ``3 * radius`` (0.6 gray where none is), through the grid hash of
    ``ops.neighbors`` on ``device`` (``"cuda"`` without a card raises);
    sets ``mesh.vertex_colors`` and returns the mesh. A Poisson mesh has no
    vertex colors; this paints it from the model cloud at save time."""
    dev = resolve_device(device)
    if cloud.colors is None or not len(cloud):
        return mesh
    pts = torch.from_numpy(np.asarray(cloud.points, np.float32)).to(dev)
    n = pts.shape[0]
    # cell size = the search reach: the 27-cell probe is complete only within
    # one cell, and a cell 3x the cloud's spacing holds ~27x its points, so
    # 32 slots a cell keep the true nearest neighbors
    cells = build_cell_lists(pts, torch.ones((n,), dtype=torch.bool, device=dev), 3 * radius,
                             auto_capacity(n), max_per_cell=32)
    v = torch.from_numpy(np.asarray(mesh.vertices, np.float32)).to(dev)
    idx, _ = knn_gather(cells, pts, v, torch.ones((v.shape[0],), dtype=torch.bool, device=dev),
                        k=1, max_radius=3 * radius)
    idx = idx[:, 0].cpu().numpy()
    cols = np.full((v.shape[0], 3), 0.6, np.float32)
    hit = idx >= 0
    cols[hit] = np.asarray(cloud.colors)[idx[hit]]
    mesh.vertex_colors = cols
    return mesh
