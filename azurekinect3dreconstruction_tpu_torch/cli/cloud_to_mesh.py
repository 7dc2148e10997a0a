"""Standalone PLY point cloud -> mesh converter: the port's counterpart of
the JAX package's ``scripts/cloud_to_mesh.py``.

    python -m azurekinect3dreconstruction_tpu_torch.cli.cloud_to_mesh \\
        cloud.ply mesh.ply --method auto --voxel 0.01

Preprocesses the cloud (voxel downsample, statistical outlier removal, PCA
normals oriented toward a point 2 m below its centroid in z), then meshes
it: ``poisson`` (Open3D, with density-quantile culling), ``ballpivot``
(Open3D's, else the first-party one), ``sdf`` (the first-party SDF splat),
or ``auto``, the chain Poisson -> ball pivoting -> SDF. The device steps
run on ``--device`` (the card by default).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device
from azurekinect3dreconstruction_tpu_torch.core.types import PointCloudHost
from azurekinect3dreconstruction_tpu_torch.meshing.poisson import (
    ball_pivot_mesh_from_cloud,
    mesh_with_fallback,
    poisson_mesh_from_cloud,
)
from azurekinect3dreconstruction_tpu_torch.meshing.sdf_mesh import sdf_mesh_from_cloud
from azurekinect3dreconstruction_tpu_torch.ops.neighbors import (
    estimate_normals_knn,
    remove_statistical_outliers,
    voxel_downsample_arrays,
)
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_error, log_info
from azurekinect3dreconstruction_tpu_torch.viz.savers import read_ply, write_ply_mesh


def preprocess(verts, cols, voxel: float, dev) -> PointCloudHost:
    """Downsample, outlier removal and oriented PCA normals, on ``dev``."""
    n = verts.shape[0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    dp, dm, dc, _ = voxel_downsample_arrays(t(verts), torch.ones((n,), dtype=torch.bool,
                                                                 device=dev),
                                            voxel, 1 << max(12, (n - 1).bit_length()),
                                            colors=None if cols is None else t(cols))
    dm = remove_statistical_outliers(dp, dm, k=16, radius=3 * voxel)
    centroid = verts.mean(0) + np.array([0, 0, -2.0], np.float32)
    nr = estimate_normals_knn(dp, dm, radius=3 * voxel, k=16, orient_to=centroid)
    m = dm.cpu().numpy()
    return PointCloudHost(points=dp.cpu().numpy()[m],
                          colors=None if dc is None else dc.cpu().numpy()[m],
                          normals=nr.cpu().numpy()[m])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input", help="input .ply point cloud")
    ap.add_argument("output", nargs="?", default=None, help="output .ply mesh")
    ap.add_argument("--voxel", type=float, default=0.01)
    ap.add_argument("--depth", type=int, default=9, help="Poisson depth")
    ap.add_argument("--method", default="auto", choices=["auto", "poisson", "ballpivot", "sdf"],
                    help="auto = Poisson -> ball-pivot -> sdf fallback chain")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu, for the device steps")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    verts, cols, _ = read_ply(args.input)
    if verts is None or not len(verts):
        log_error(f"no points in {args.input}")
        return 1
    log_info(f"loaded {verts.shape[0]} points")
    cloud = preprocess(verts, cols, args.voxel, dev)
    log_info(f"preprocessed -> {len(cloud)} points")

    if args.method == "sdf":
        mesh = sdf_mesh_from_cloud(cloud, voxel=args.voxel, device=dev)
    elif args.method == "poisson":
        mesh = poisson_mesh_from_cloud(cloud, depth=args.depth)
    elif args.method == "ballpivot":
        mesh = ball_pivot_mesh_from_cloud(cloud, device=dev)
    else:
        mesh = mesh_with_fallback(cloud, voxel=args.voxel, depth=args.depth, device=dev)
    if mesh is None:
        log_error("meshing failed; wrote nothing")
        return 1
    out = args.output or args.input.replace(".ply", "_mesh.ply")
    write_ply_mesh(out, mesh)
    log_info(f"wrote {out} ({mesh.triangles.shape[0]} triangles)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
