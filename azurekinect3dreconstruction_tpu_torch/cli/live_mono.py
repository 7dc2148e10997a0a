"""Live single-camera odometry + TSDF, headless: the port's counterpart of
the JAX package's ``scripts/live_mono.py``.

    python -m azurekinect3dreconstruction_tpu_torch.cli.live_mono \\
        --source synthetic --frames 24 --streaming --output results

Tracks and fuses every frame (``MonoOdometryTSDF``), and on exit saves the
welded mesh, the volume's point cloud and the trajectory (and, on the
synthetic source, the true trajectory in the pipeline's frame) through
``viz.savers.ResultSaver``. ``--streaming`` streams far blocks to host
memory (``tsdf.streaming.StreamingTSDF``), so the scan's extent is not
bounded by the device pool; the saves then assemble live and streamed
geometry. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np

from azurekinect3dreconstruction_tpu_torch.cli.common import add_common_args, make_source
from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig, TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core.types import PointCloudHost
from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import MonoOdometryTSDF
from azurekinect3dreconstruction_tpu_torch.tsdf.marching_cubes import weld_vertices
from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import StreamingTSDF
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info
from azurekinect3dreconstruction_tpu_torch.viz.savers import ResultSaver


def save(pipe: MonoOdometryTSDF, saver: ResultSaver, gt_poses=None) -> None:
    """Mesh (welded, with vertex normals), volume cloud, trajectory, and the
    true trajectory in the pipeline's frame (world = camera 0) when known."""
    mesh = weld_vertices(pipe.extract_mesh().compact())
    mesh.compute_vertex_normals()
    saver.save_mesh(mesh, kind="mesh")
    pts, cols = pipe.extract_point_cloud()
    saver.save_point_cloud(PointCloudHost(points=pts, colors=cols), kind="volume_pcd")
    saver.save_trajectory(pipe.trajectory)
    if gt_poses:
        inv0 = np.linalg.inv(gt_poses[0])
        saver.save_trajectory([np.eye(4)] + [inv0 @ P for P in gt_poses[:pipe.frame_index]],
                              kind="gt_trajectory")
    log_info(f"saved mesh ({mesh.triangles.shape[0]} triangles) + cloud ({pts.shape[0]} points)"
             " + trajectory; the preview image is skipped (no renderer in the port)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    ap.add_argument("--voxel", type=float, default=0.01, help="TSDF voxel (m)")
    ap.add_argument("--tracking", default="frame_to_frame",
                    choices=["frame_to_frame", "frame_to_model"],
                    help="frame_to_model refines odometry against the fused model (less drift)")
    ap.add_argument("--streaming", action="store_true",
                    help="stream far TSDF blocks to host memory (a scene of any extent on the "
                         "fixed device pool; saves assemble live and streamed geometry)")
    ap.add_argument("--relocalize", action="store_true",
                    help="recover from tracking loss by registering the live frame against the "
                         "fused model (fusion pauses while the pose is untrusted)")
    args = ap.parse_args(argv)

    frames, intr = make_source(args)
    cfg = PipelineConfig(tsdf=TSDFConfig(voxel_size=args.voxel, sdf_trunc=4 * args.voxel))
    streaming = None
    if args.streaming:
        streaming = StreamingTSDF.for_pipeline(cfg, device=args.device)
        log_info(f"streaming: reload<{streaming.reload_dist:.2f} m, "
                 f"evict>{streaming.evict_dist:.2f} m, high water {streaming.high_water} blocks")
    pipe = MonoOdometryTSDF(intr, cfg, device=args.device, tracking=args.tracking,
                            streaming=streaming, relocalize=args.relocalize)
    for depth, color in frames:
        pipe.process_frame(depth, color)
    log_info(f"{pipe.frame_index} frames, {pipe.odometry_failures} gate rejections, "
             f"n_blocks {int(pipe.volume.n_blocks)}, overflow {bool(pipe.volume.overflow)}"
             + (f", {streaming.n_evictions} evictions, {streaming.n_reloads} reloads, "
                f"{streaming.n_stored} blocks stored" if streaming is not None else ""))
    save(pipe, ResultSaver(args.output), getattr(args, "gt_poses", None))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
