"""Offline-optimized SLAM, BundleFusion style (the counterpart of the JAX
package's ``pipelines/offline_bundle.py``).

Per frame: log the raw frame to ``frames/frame_%06d.npz`` (the checkpoint),
track it against the previous one by dense odometry
(:func:`tracking.odometry.compute_odometry`, the reference's plain form) and
add a pose-graph node and an odometry edge. Every ``loop_check_interval``
frames, positional loop closures (closer than ``loop_radius``, at least
``loop_min_gap`` frames apart) are verified by odometry between the two
logged frames and the graph is re-optimized online. ``finalize`` sweeps for
loops once more, optimizes the graph globally (LM, prune 0.25, preference
2.0), reintegrates every logged frame into a reset volume at its optimized
pose (B1 once a frame, :func:`make_raw_batch_fn`), and extracts, welds and
saves the mesh and the trajectory. ``resume`` rebuilds from the frame log
and the pose-graph JSON.

Unlike the reference, the reintegration cannot lose a block: its worklist
spans the whole pool (B1 bounds itself by the live row count on the
device), and ``finalize`` reads the volume's ``overflow`` flag once and
raises if it is set.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device, upload
from azurekinect3dreconstruction_tpu_torch.core.types import RGBDFrame, _host
from azurekinect3dreconstruction_tpu_torch.io.replay import (
    FrameRecorder,
    NpzReplaySource,
    load_frame,
)
from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import make_raw_batch_fn
from azurekinect3dreconstruction_tpu_torch.tracking import posegraph as pg
from azurekinect3dreconstruction_tpu_torch.tracking.odometry import compute_odometry
from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import (
    Telemetry,
    log_info,
    log_warning,
)
from azurekinect3dreconstruction_tpu_torch.viz.savers import ResultSaver


class OfflineBundle:
    """Feed raw (depth_u16, color_u8) frames, then ``finalize``.

    ``device`` is ``"cuda"``, the default (kernel B1 on the card in the
    reintegration) or ``"cpu"`` (its plain version); ``"cuda"`` without a card
    raises. ``last_finalize_stats`` holds the last finalize's stage wall times
    (``loops_s``, ``optimize_s``, ``reintegrate_s``, ``extract_s``) and
    ``n_frames``; ``volume`` is its reintegrated volume."""

    def __init__(self, intrinsics: Intrinsics, config: Optional[PipelineConfig] = None, *,
                 device="cuda", output_dir: str = "reconstruction_output", loop_radius: float = 0.5,
                 loop_min_gap: int = 20, loop_check_interval: int = 10,
                 checkpoint_interval: int = 100):
        self.device = resolve_device(device)
        self.intr = intrinsics
        self.cfg = config or PipelineConfig()
        self.rays = pixel_rays(intrinsics, self.device)
        self.output_dir = output_dir
        self.frames_dir = os.path.join(output_dir, "frames")
        self.recorder = FrameRecorder(self.frames_dir)
        self.graph = pg.PoseGraph()
        self.prev: Optional[RGBDFrame] = None
        self.loop_radius = loop_radius
        self.loop_min_gap = loop_min_gap
        self.loop_check_interval = loop_check_interval
        self.checkpoint_interval = checkpoint_interval
        self._known_loops = set()
        self.volume = None
        self.last_finalize_stats: dict = {}
        self.telemetry = Telemetry()
        self.saver = ResultSaver(output_dir)

    @property
    def n_frames(self) -> int:
        return len(self.graph.nodes)

    def _decode(self, depth_raw, color_raw) -> RGBDFrame:
        cam = self.cfg.camera
        return RGBDFrame.from_raw(upload(depth_raw, self.device), upload(color_raw, self.device),
                                  cam.depth_scale, cam.depth_trunc, cam.depth_min)

    def _odometry(self, fs: RGBDFrame, ft: RGBDFrame):
        return compute_odometry(fs.intensity, fs.depth, ft.intensity, ft.depth, self.intr,
                                self.cfg.odometry)

    def process_frame(self, depth_raw, color_raw) -> np.ndarray:
        """Log and track one frame (nothing is integrated until finalize);
        returns its node's camera-to-world pose. Reads the odometry's
        fitness on the host, as the graph needs it."""
        frame = self._decode(depth_raw, color_raw)
        self.recorder.write(_host(depth_raw), _host(color_raw))
        if self.prev is None:
            self.graph.add_node(np.eye(4))
        else:
            res = self._odometry(self.prev, frame)
            ok = float(res.fitness) > 0.3
            T_rel = (np.linalg.inv(res.T_target_source.cpu().numpy().astype(np.float64))
                     if ok else np.eye(4))
            if not ok:
                self.telemetry.count("odo_fail")
                log_warning("odometry failed; identity edge")
            i = len(self.graph.nodes)
            self.graph.add_node(self.graph.nodes[-1] @ T_rel)
            # edge (i-1, i): the transform mapping node-i coordinates into node i-1's
            self.graph.add_edge(i - 1, i, T_rel)
            if i % self.loop_check_interval == 0:
                self._detect_loops()
            if self.checkpoint_interval and i % self.checkpoint_interval == 0:
                self.graph.save(os.path.join(self.output_dir, "pose_graph.json"))
        self.prev = frame
        self.telemetry.tick_frame()
        self.telemetry.maybe_report()
        return self.graph.nodes[-1]

    def _detect_loops(self) -> int:
        """Positional loop closures, at most 3 a check (nearest first), each
        verified by odometry between the two logged frames at fitness >=
        0.5, then an online re-optimization. Returns the edges added."""
        positions = [n[:3, 3] for n in self.graph.nodes]
        cands = pg.find_loop_closures(positions, self.loop_radius, self.loop_min_gap,
                                      exclude=self._known_loops)
        files = NpzReplaySource(self.frames_dir).files
        added = 0
        for i, j in cands[:3]:
            self._known_loops.add((i, j))
            res = self._odometry(self._decode(*load_frame(files[i])),
                                 self._decode(*load_frame(files[j])))
            if float(res.fitness) < 0.5:
                continue
            T_rel = np.linalg.inv(res.T_target_source.cpu().numpy().astype(np.float64))
            self.graph.add_edge(i, j, T_rel, uncertain=True)
            added += 1
        if added:
            log_info(f"added {added} loop closure(s); re-optimizing online")
            self.graph = pg.optimize(self.graph, max_iterations=15)
            self.telemetry.count("loop_closures", added)
        return added

    def finalize(self, extract: bool = True):
        """Optimize the pose graph, reintegrate every logged frame into a
        reset volume at its optimized pose, and (with ``extract``) extract,
        weld and save the mesh and the optimized trajectory. Returns the
        welded mesh, or None without ``extract``. Raises ``RuntimeError``
        if the reintegration set the volume's ``overflow`` flag."""
        stats = {"n_frames": len(self.graph.nodes)}
        t0 = time.perf_counter()
        log_info("finalizing: global optimization + reintegration")
        # one last loop sweep: the cadence check never sees the final
        # frames, and a scan usually ends where it started
        if len(self.graph.nodes) > self.loop_min_gap:
            self._detect_loops()
        stats["loops_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.graph.save(os.path.join(self.output_dir, "pose_graph.json"))
        self.graph = pg.optimize(self.graph, max_iterations=50, edge_prune_threshold=0.25,
                                 preference_loop_closure=2.0)
        stats["optimize_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        volume = self._reintegrate(tsdf.create(self.cfg.tsdf, self.device))
        overflow = bool(volume.overflow)  # the one read: it waits for the reintegration
        stats["reintegrate_s"] = time.perf_counter() - t0
        self.volume = volume
        self.last_finalize_stats = stats
        if overflow:
            raise RuntimeError("reintegration overflowed the volume: enlarge "
                               "tsdf.block_capacity (or hash_capacity)")
        if not extract:
            return None
        t0 = time.perf_counter()
        mesh = mc.weld_vertices(mc.extract_mesh(volume, self.cfg.tsdf).compact())
        mesh.compute_vertex_normals()
        self.saver.save_mesh(mesh, kind="optimized_mesh")
        self.saver.save_trajectory(self.graph.nodes, kind="optimized_trajectory")
        stats["extract_s"] = time.perf_counter() - t0
        return mesh

    def _reintegrate(self, volume, chunk: int = 16):
        """Every logged frame into ``volume`` at its optimized pose, through
        :func:`make_raw_batch_fn` with a whole-pool worklist; the raw frames
        go up a chunk at a time."""
        src = NpzReplaySource(self.frames_dir)
        n = min(len(src), len(self.graph.nodes))
        cam = self.cfg.camera
        batch = make_raw_batch_fn(self.intr, self.cfg.tsdf)
        frames = src.frames()
        for a in range(0, n, chunk):
            ds, cs = zip(*(next(frames) for _ in range(min(chunk, n - a))))
            Ts = np.stack([self.graph.nodes[i] for i in range(a, a + len(ds))])
            volume = batch(volume, upload(np.stack(ds), self.device),
                           upload(np.stack(cs), self.device),
                           upload(Ts.astype(np.float32), self.device), self.rays,
                           1.0 / cam.depth_scale, cam.depth_min, cam.depth_trunc)
        return volume

    @staticmethod
    def resume(intrinsics: Intrinsics, output_dir: str, config: Optional[PipelineConfig] = None,
               **kw) -> "OfflineBundle":
        """Rebuild from ``output_dir``'s frame log and pose-graph JSON,
        tracking any frame logged after the last checkpoint. ``kw`` goes to
        the constructor (``device`` among it)."""
        self = OfflineBundle(intrinsics, config, output_dir=output_dir, **kw)
        pgp = os.path.join(output_dir, "pose_graph.json")
        if os.path.exists(pgp):
            self.graph = pg.PoseGraph.load(pgp)
        src = NpzReplaySource(self.frames_dir)
        self.recorder.count = len(src)
        if len(src) and len(self.graph.nodes) < len(src):
            for i, (d, c) in enumerate(src):
                if i < len(self.graph.nodes):
                    self.prev = self._decode(d, c)
                    continue
                self.recorder.count = i  # process_frame rewrites entry i as it was
                self.process_frame(d, c)
        return self
