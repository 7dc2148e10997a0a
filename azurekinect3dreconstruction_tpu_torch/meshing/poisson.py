"""Host-side surface meshing of point clouds: Poisson, ball pivoting and the
fallback chain (the counterpart of the JAX package's ``meshing/poisson.py``).

Poisson reconstruction is an octree multigrid solver; it stays an optional
Open3D delegate on the host. Ball pivoting falls back to the first-party
:mod:`.ball_pivot` when Open3D is absent, and the SDF-splat mesher of
:mod:`.sdf_mesh` is the last rung, so the chain needs no Open3D.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device
from azurekinect3dreconstruction_tpu_torch.core.types import PointCloudHost, TriangleMeshHost
from azurekinect3dreconstruction_tpu_torch.meshing.ball_pivot import ball_pivot_mesh
from azurekinect3dreconstruction_tpu_torch.meshing.sdf_mesh import sdf_mesh_from_cloud
from azurekinect3dreconstruction_tpu_torch.ops.neighbors import estimate_normals_knn
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_warning

# the first-party ball pivot's advancing front is a host Python loop: the
# chain hands clouds larger than this to the SDF mesher instead
BALL_PIVOT_MAX_POINTS = 60000


def _o3d():
    try:
        import open3d as o3d  # noqa

        return o3d
    except ImportError:
        return None


def _to_o3d_cloud(cloud: PointCloudHost):
    o3d = _o3d()
    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(cloud.points.astype(np.float64))
    if cloud.colors is not None:
        pcd.colors = o3d.utility.Vector3dVector(cloud.colors.astype(np.float64))
    if cloud.normals is not None:
        pcd.normals = o3d.utility.Vector3dVector(cloud.normals.astype(np.float64))
    return pcd


def _from_o3d_mesh(mesh) -> TriangleMeshHost:
    return TriangleMeshHost(
        vertices=np.asarray(mesh.vertices, np.float32),
        triangles=np.asarray(mesh.triangles, np.int32),
        vertex_colors=(np.asarray(mesh.vertex_colors, np.float32)
                       if len(mesh.vertex_colors) else None),
    )


def poisson_mesh_from_cloud(cloud: PointCloudHost, depth: int = 9,
                            density_quantile: float = 0.01) -> Optional[TriangleMeshHost]:
    """Poisson reconstruction, then the vertices below the density quantile
    culled. None when Open3D is not installed or the cloud has under 100
    points."""
    o3d = _o3d()
    if o3d is None:
        log_warning("open3d not installed; Poisson meshing unavailable "
                    "(use the TSDF marching-cubes mesher)")
        return None
    if len(cloud) < 100:
        return None
    pcd = _to_o3d_cloud(cloud)
    if cloud.normals is None:
        pcd.estimate_normals()
        pcd.orient_normals_consistent_tangent_plane(30)
    mesh, densities = o3d.geometry.TriangleMesh.create_from_point_cloud_poisson(pcd, depth=depth)
    densities = np.asarray(densities)
    keep = densities >= np.quantile(densities, density_quantile)
    mesh.remove_vertices_by_mask(~keep)
    return _from_o3d_mesh(mesh)


def ball_pivot_mesh_from_cloud(cloud: PointCloudHost, radii=(0.005, 0.01, 0.02, 0.04), *,
                               device="cuda") -> Optional[TriangleMeshHost]:
    """Ball pivoting over the radius ladder: Open3D's when it is installed,
    else the first-party one, for which a cloud without normals gets PCA
    normals on ``device`` oriented toward a point 2 m below its centroid in
    z. None under 100 points; ``"cuda"`` without a card raises."""
    dev = resolve_device(device)
    if len(cloud) < 100:
        return None
    o3d = _o3d()
    if o3d is None:
        if cloud.normals is None:
            n = estimate_normals_knn(
                torch.from_numpy(np.asarray(cloud.points, np.float32)).to(dev),
                torch.ones((len(cloud),), dtype=torch.bool, device=dev),
                radius=3 * float(radii[0]), k=16,
                orient_to=cloud.points.mean(0) + np.array([0, 0, -2.0]))
            cloud = PointCloudHost(points=cloud.points, colors=cloud.colors,
                                   normals=n.cpu().numpy())
        return ball_pivot_mesh(cloud, radii=radii)
    pcd = _to_o3d_cloud(cloud)
    if cloud.normals is None:
        pcd.estimate_normals()
    mesh = o3d.geometry.TriangleMesh.create_from_point_cloud_ball_pivoting(
        pcd, o3d.utility.DoubleVector(list(radii)))
    return _from_o3d_mesh(mesh)


def mesh_with_fallback(cloud: PointCloudHost, voxel: float = 0.01, *, device="cuda",
                       **kw) -> Optional[TriangleMeshHost]:
    """Poisson, then ball pivoting, then the SDF-splat mesher at ``voxel``,
    each rung taken when the one before gives no triangles. Without Open3D
    a cloud over ``BALL_PIVOT_MAX_POINTS`` skips the first-party ball pivot
    (a host loop). ``kw`` goes to :func:`poisson_mesh_from_cloud`; the
    device steps run on ``device`` (``"cuda"`` without a card raises)."""
    device = resolve_device(device)
    mesh = poisson_mesh_from_cloud(cloud, **kw)
    if mesh is None or mesh.triangles.shape[0] == 0:
        if _o3d() is not None or len(cloud) <= BALL_PIVOT_MAX_POINTS:
            mesh = ball_pivot_mesh_from_cloud(cloud, device=device)
        else:
            log_warning(f"fallback chain: skipping first-party ball pivot ({len(cloud)} points "
                        f"> {BALL_PIVOT_MAX_POINTS // 1000}k); using the SDF mesher")
    if mesh is None or mesh.triangles.shape[0] == 0:
        mesh = sdf_mesh_from_cloud(cloud, voxel=voxel, device=device)
    return mesh
