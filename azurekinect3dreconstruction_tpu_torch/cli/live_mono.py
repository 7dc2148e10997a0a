"""Live single-camera odometry + TSDF: the port's counterpart of the JAX
package's ``scripts/live_mono.py``.

    python -m azurekinect3dreconstruction_tpu_torch.cli.live_mono \\
        --source synthetic --frames 24 [--serve 8000] [--streaming] --output results

Tracks and fuses every frame (``MonoOdometryTSDF``), each uploaded while
the previous one computes (``io.streams.prefetch_to_device``), and on exit
saves the welded mesh, the volume's point cloud, the trajectory (and, on
the synthetic source, the true trajectory in the pipeline's frame) and a
PNG preview of the mesh through ``viz.savers.ResultSaver``. ``--streaming``
streams far blocks to host memory (``tsdf.streaming.StreamingTSDF``), so the
scan's extent is not bounded by the device pool; the saves then assemble
live and streamed geometry. Runs on the card unless ``--device cpu``.

``--serve PORT`` shows the reconstruction in a browser (``viz.live_server``
on 127.0.0.1:PORT); without it an Open3D window opens when Open3D imports
and ``--headless`` is not given. Every ``vis_update_interval`` frames the
viewer gets the surface: the point cloud, or in mesh mode the incremental
extractor's soup (``tsdf.incremental.IncrementalExtractor``), and the
status line the frame index and the frame rate. Keys, dispatched on the
loop's thread at the viewer's next ``tick``: C reset the volume, S save,
M toggle mesh / point cloud, = / - depth scale +-100 units a metre, ] / [
depth truncation +-0.5 m; a tuning key acts from the next frame on.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from azurekinect3dreconstruction_tpu_torch.cli.common import (
    add_common_args,
    add_viewer_args,
    make_source,
    make_viewer,
)
from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig, TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core.types import PointCloudHost
from azurekinect3dreconstruction_tpu_torch.io.streams import prefetch_to_device
from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import MonoOdometryTSDF
from azurekinect3dreconstruction_tpu_torch.tsdf.incremental import IncrementalExtractor
from azurekinect3dreconstruction_tpu_torch.tsdf.marching_cubes import weld_vertices
from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import StreamingTSDF, integration_reach
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info, log_warning
from azurekinect3dreconstruction_tpu_torch.viz.savers import ResultSaver


class LiveSession:
    """The live loop: a pipeline, the viewer it shows on and its key map.

    :meth:`run` drives frames through the pipeline and feeds the viewer.
    What the loop sent is kept for inspection: ``sent`` maps "mesh" and
    "cloud" to the (frame index, geometry) last sent in that mode,
    ``vis_frames`` lists (frame index, mode) of every update and ``keys``
    (frame index, key) of every key handled, in order."""

    CLOUD_POINTS = 200000  # points of the cloud shown

    def __init__(self, pipe: MonoOdometryTSDF, viewer, saver: ResultSaver, *,
                 streaming=None, gt_poses=None):
        self.pipe, self.viewer, self.saver = pipe, viewer, saver
        self.streaming = streaming
        self.gt_poses = gt_poses
        self.inc = IncrementalExtractor(pipe.cfg.tsdf)
        self.mesh_mode = False
        self.frame = -1  # index of the frame in the loop
        self.sent = {}
        self.vis_frames = []
        self.keys = []
        for char, fn, desc in (
                ("C", pipe.reset, "reset volume (scene change)"),
                ("S", self.save, "save mesh/cloud/trajectory/preview"),
                ("M", self.toggle_mesh, "toggle mesh / point-cloud display"),
                ("=", lambda: self.tune(scale_d=+100), "depth scale +100"),
                ("-", lambda: self.tune(scale_d=-100), "depth scale -100"),
                ("]", lambda: self.tune(trunc_d=+0.5), "depth trunc +0.5m"),
                ("[", lambda: self.tune(trunc_d=-0.5), "depth trunc -0.5m")):
            viewer.register_key(char, self._logged(char, fn), desc)

    def _logged(self, char, fn):
        def handler():
            self.keys.append((self.frame, char))
            fn()
        return handler

    def toggle_mesh(self) -> None:
        self.mesh_mode = not self.mesh_mode

    def tune(self, scale_d: float = 0.0, trunc_d: float = 0.0) -> None:
        """Live depth decoding: the pipeline reads ``cfg.camera`` every
        frame, so the next frame decodes with the new scale and truncation."""
        pipe = self.pipe
        cam = pipe.cfg.camera
        pipe.cfg = dataclasses.replace(pipe.cfg, camera=cam.replace(
            depth_scale=max(cam.depth_scale + scale_d, 100.0),
            depth_trunc=max(cam.depth_trunc + trunc_d, 0.5)))
        log_info(f"depth_scale {pipe.cfg.camera.depth_scale:.0f} "
                 f"depth_trunc {pipe.cfg.camera.depth_trunc:.2f}")
        if self.streaming is not None:
            # the streaming distances come from the startup truncation; a
            # frame that reaches past the reload ring turns frozen caches into
            # merge-and-refresh churn
            reach = integration_reach(pipe.cfg)
            if reach > self.streaming.reload_dist:
                log_warning(f"depth_trunc raises the integration reach to {reach:.2f} m > the "
                            f"streaming reload ring {self.streaming.reload_dist:.2f} m: restart "
                            "with the larger truncation to derive safe distances")

    def save(self) -> None:
        """Mesh (welded, with vertex normals), volume cloud, trajectory, the
        true trajectory in the pipeline's frame (world = camera 0) when
        known, and a PNG preview of the mesh."""
        pipe, saver = self.pipe, self.saver
        mesh = weld_vertices(pipe.extract_mesh().compact())
        mesh.compute_vertex_normals()
        saver.save_mesh(mesh, kind="mesh")
        pts, cols = pipe.extract_point_cloud()
        saver.save_point_cloud(PointCloudHost(points=pts, colors=cols), kind="volume_pcd")
        saver.save_trajectory(pipe.trajectory)
        if self.gt_poses:
            inv0 = np.linalg.inv(self.gt_poses[0])
            saver.save_trajectory(
                [np.eye(4)] + [inv0 @ P for P in self.gt_poses[:pipe.frame_index]],
                kind="gt_trajectory")
        saver.save_preview(mesh)
        log_info(f"saved mesh ({mesh.triangles.shape[0]} triangles) + cloud ({pts.shape[0]} "
                 "points) + trajectory + preview")

    def _show(self, i: int) -> None:
        pipe, viewer = self.pipe, self.viewer
        if self.mesh_mode:
            # with streaming: the resident region (the save assembles all)
            mode, geom = "mesh", self.inc.update(pipe.volume)
            viewer.update_mesh("surface", geom)
        else:
            pts, cols = pipe.extract_point_cloud(max_points=self.CLOUD_POINTS)
            mode, geom = "cloud", PointCloudHost(points=pts, colors=cols)
            viewer.update_cloud("surface", geom)
        self.sent[mode] = (i, geom)
        self.vis_frames.append((i, mode))
        if hasattr(viewer, "set_status"):  # the browser page's status line
            viewer.set_status(f"frame {i} | {pipe.telemetry.fps:.1f} fps")

    def run(self, frames, on_frame=None) -> None:
        """Frames through the pipeline (uploaded one ahead); every
        ``vis_update_interval``-th frame to the viewer unless it is
        headless; ``on_frame(session, i)`` after each frame's work is
        enqueued; then the viewer's ``tick``, which runs the keys pressed
        since the last one and ends the loop when it returns False."""
        pipe = self.pipe
        for i, (depth, color) in enumerate(prefetch_to_device(frames, device=pipe.device)):
            self.frame = i
            pipe.process_frame(depth, color)
            if i % pipe.cfg.vis_update_interval == 0 and not self.viewer.headless:
                self._show(i)
            if on_frame is not None:
                on_frame(self, i)
            if not self.viewer.tick():
                break


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    add_viewer_args(ap)
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
    ap.add_argument("--reloc-warmup", action="store_true",
                    help="with --relocalize: run the recovery path once at startup, so that the "
                         "first loss does not pay its one-time set-up")
    args = ap.parse_args(argv)

    frames, intr = make_source(args)
    cfg = PipelineConfig(tsdf=TSDFConfig(voxel_size=args.voxel, sdf_trunc=4 * args.voxel))
    streaming = None
    if args.streaming:
        streaming = StreamingTSDF.for_pipeline(cfg, device=args.device,
                                               tracking=args.tracking)
        log_info(f"streaming: reload<{streaming.reload_dist:.2f} m, "
                 f"evict>{streaming.evict_dist:.2f} m, high water {streaming.high_water} blocks")
    pipe = MonoOdometryTSDF(intr, cfg, device=args.device, tracking=args.tracking,
                            streaming=streaming, relocalize=args.relocalize,
                            reloc_warmup=args.relocalize and args.reloc_warmup)
    viewer = make_viewer(args, "mono odometry+TSDF")
    try:
        session = LiveSession(pipe, viewer, ResultSaver(args.output), streaming=streaming,
                              gt_poses=getattr(args, "gt_poses", None))
        session.run(frames)
        log_info(f"{pipe.frame_index} frames, {pipe.odometry_failures} gate rejections, "
                 f"n_blocks {int(pipe.volume.n_blocks)}, overflow {bool(pipe.volume.overflow)}"
                 + (f", {streaming.n_evictions} evictions, {streaming.n_reloads} reloads, "
                    f"{streaming.n_stored} blocks stored" if streaming is not None else ""))
        session.save()
    finally:
        viewer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
