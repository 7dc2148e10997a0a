"""Two-camera fusion with one-shot extrinsic auto-calibration (the
counterpart of the JAX package's ``pipelines/dual_fusion.py``).

The first good frame pair calibrates camera 1's extrinsic: voxel downsample
and outlier removal of both clouds, PCA normals, FPFH, mutual feature
matching, RANSAC, then projective ICP (point-to-plane, or colored ICP)
against camera 0's maps and an overlap gate. Calibration runs once per
session and may wait on the device. After it, the hot loop per pair is two
raw uploads, one pose upload and the enqueue of :func:`make_raw_dual_step`
(decode both frames, then allocate, worklist and integrate (kernel B1) for
each camera), with no host synchronization: the extrinsics and the
camera-1 gate are tensor data, so a recalibration or a moving rig changes
the data, not the step. Display and recalibration decode the last pair on
demand; ``save_current_state`` writes the merged cloud and the TSDF mesh (and
a Poisson mesh of the cloud on request). In sharded mode the volume is a
(cam x blk) :class:`parallel.sharded_volume.ShardedTSDF` fed by its raw
step (B1 once a camera a shard), and meshing runs on the shards combined.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig, TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core import se3
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu_torch.core.device import (
    full_fp32_matmul,
    resolve_device,
    upload,
)
from azurekinect3dreconstruction_tpu_torch.core.types import (
    PointCloudHost,
    RGBDFrame,
    decode_raw_frame,
)
from azurekinect3dreconstruction_tpu_torch.meshing.poisson import poisson_mesh_from_cloud
from azurekinect3dreconstruction_tpu_torch.ops.backproject import backproject_depth
from azurekinect3dreconstruction_tpu_torch.ops.image import depth_gradient_colors
from azurekinect3dreconstruction_tpu_torch.ops.kernels.tsdf_kernels import integrate_step
from azurekinect3dreconstruction_tpu_torch.ops.neighbors import (
    estimate_normals_knn,
    remove_statistical_outliers,
    voxel_downsample_arrays,
)
from azurekinect3dreconstruction_tpu_torch.parallel import sharded_volume as sv
from azurekinect3dreconstruction_tpu_torch.tracking.features import compute_fpfh
from azurekinect3dreconstruction_tpu_torch.tracking.icp import (
    FREE_SPACE_BAND_M,
    FREE_SPACE_MAX_SHARE,
    TargetMaps,
    colored_icp,
    evaluate_registration,
    free_space_band,
    free_space_shares,
    icp_point_to_plane,
)
from azurekinect3dreconstruction_tpu_torch.tracking.ransac import (
    match_features,
    ransac_registration,
)
from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import Telemetry
from azurekinect3dreconstruction_tpu_torch.viz.savers import ResultSaver

log = logging.getLogger(__name__)

_UNIFORM_COLORS = ((0.9, 0.4, 0.2), (0.2, 0.5, 0.9))
# the most pixels in front that the candidate of best overlap may leave and still be taken
# without the colored refinement: at the truth noise-free depth leaves 0.2-0.5 % (edges),
# while a pose slid 1-2.5 cm along the scene's planes leaves 1-3 %, under the gate. The fast
# path saves the colored refinement's ~3 s once a session. It stays because a sensor whose
# band sits at its 3 cm floor (relative noise under ~0.6 % at 1 m) may take it; 1 % noise
# widens the band and sends every calibration the colored way whatever this share. A real
# sensor's share at the truth has not been read yet: until it is, 1 % rests on renders
FAST_PATH_MAX_SHARE = 0.01
# the route for a rig the auto-calibration rejects
RIG_CALIB_ADVICE = ("calibrate the rig with a checkerboard (python -m "
                    "azurekinect3dreconstruction_tpu_torch.cli.calibrate_rig) and fuse with "
                    "cli.dual_fusion --rig-calib DIR")


class DualCameraFusion:
    """Feed synchronized raw (depth_u16, color_u8) pairs from two cameras.

    ``device`` is ``"cuda"``, the default (kernel B1 on the card) or ``"cpu"``
    (its plain version); ``"cuda"`` without a card raises. Camera 0 defines the
    world frame: ``extrinsics[i]`` is camera i's camera-to-world pose (host
    float64), camera 1's ``None`` until calibrated. ``colored_calibration``
    refines with colored ICP instead of point-to-plane. RANSAC draws from
    ``generator``, a ``torch.Generator`` on the device seeded with 7.
    ``calib_stage_ms`` holds the last calibration's stage times, each closed by
    a device synchronization, and ``calib_scores`` the overlap and the
    free-space shares (``in_front``, ``agree``) of the pose it accepted or,
    when it rejected, of the one that came nearest, and the free-space
    band at camera 0's median depth (``band_m``).

    ``sharded``: camera ``c`` on row ``c`` of a ``2 x n // 2`` grid of
    ``devices`` (default: every visible card on ``"cuda"``, ``[device]`` on
    the CPU; a device may repeat), the volume block-sharded over its
    columns (``parallel.sharded_volume.make_sharded_raw_step``, stride 2).
    With fewer than 2 devices, or different intrinsics for the two
    cameras, it logs a warning and runs unsharded; ``self.sharded`` says
    which.

    ``telemetry`` (:class:`utils.telemetry.Telemetry`) ticks once a pair,
    counts ``calib_ok`` / ``calib_reject`` and times the ``step`` on the
    host clock (on a card, the time to enqueue it)."""

    COLOR_MODES = ("rgb", "depth_gradient", "uniform")

    def __init__(self, intrinsics: Tuple[Intrinsics, Intrinsics],
                 config: Optional[PipelineConfig] = None, *, device="cuda",
                 output_dir: str = "results", colored_calibration: bool = False,
                 sharded: bool = False, devices=None):
        self.device = resolve_device(device)
        self.intr = list(intrinsics)
        self.cfg = config or PipelineConfig()
        self.colored_calibration = colored_calibration
        self.rays = [pixel_rays(i, self.device) for i in self.intr]
        self.extrinsics: List[Optional[np.ndarray]] = [np.eye(4), None]
        self.calibrated = False
        self.color_mode = "rgb"
        self.saver = ResultSaver(output_dir)
        self.generator = torch.Generator(device=self.device).manual_seed(7)
        self.frame_index = 0
        self.calib_stage_ms = {}
        self.calib_scores = {}
        self.telemetry = Telemetry()  # pair rate, calibration events, step times (host clock)
        self._last_frames: List[Optional[RGBDFrame]] = [None, None]
        self._last_raw = [None, None]  # device (depth_raw, color_raw) of the last pair
        self._frames_stale = False  # _last_frames behind _last_raw
        self.sharded = False
        if sharded:
            if devices is None:
                devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                           if self.device.type == "cuda" else [self.device])
            n_dev = len(devices)
            if n_dev < 2:
                log.warning("sharded dual fusion needs >= 2 devices, have %d; falling back to "
                            "single-device", n_dev)
            elif self.intr[0] != self.intr[1]:
                log.warning("sharded dual fusion requires identical camera intrinsics; falling "
                            "back to single-device")
            else:
                self.mesh = sv.make_mesh(2, n_dev // 2, devices)
                self.volume = sv.create_sharded(self.cfg.tsdf, self.mesh)
                self._sharded_step = sv.make_sharded_raw_step(self.mesh, self.intr[0],
                                                              self.cfg.tsdf, stride=2)
                self.sharded = True
                log.info("sharded dual fusion: mesh cam=2 x blk=%d", n_dev // 2)
        if not self.sharded:
            self._step = make_raw_dual_step(self.intr[0], self.intr[1], self.cfg.tsdf)
            self.volume = tsdf.create(self.cfg.tsdf, self.device)

    @property
    def counts(self) -> dict:
        """Calibration event counts: ``calib_ok`` and ``calib_reject``."""
        return {k: v for k, v in self.telemetry.counters.items() if v}

    # -- calibration ------------------------------------------------------------

    def _stage_done(self, name: str, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.calib_stage_ms[name] = self.calib_stage_ms.get(name, 0.0) + (t - t0) * 1e3
        return t

    def _score(self, frames, poses, fits, band):
        """Candidate extrinsics ``T01`` on the host, float64: their (n, 4)
        rows (overlap, the larger of the two directions' free-space shares
        in front, the smaller of their shares that agree, and the band in m
        at camera 0's median depth) and the poses as numpy 4x4s. ``band``
        from ``free_space_band``. One read of the host."""
        (d0, d1), (r0, r1) = (frames[0].depth, frames[1].depth), self.rays
        band_m = band * torch.where(d0 > 0, d0, float("nan")).nanmedian()
        rows = []
        for T, fit in zip(poses, fits):
            f10, a10 = free_space_shares(d0, self.intr[0], d1, r1, T, band)
            f01, a01 = free_space_shares(d1, self.intr[1], d0, r0, se3.inverse(T), band)
            rows.append(torch.cat([torch.stack([fit.to(torch.float32), torch.maximum(f10, f01),
                                                torch.minimum(a10, a01), band_m]),
                                   T.reshape(16)]))
        host = torch.stack(rows).cpu().numpy().astype(np.float64)
        return host[:, :4], list(host[:, 4:].reshape(-1, 4, 4))

    def calibrate(self, frames: Tuple[RGBDFrame, RGBDFrame], refine_only: bool = False,
                  colored: bool = False) -> bool:
        """Estimate camera 1's extrinsic from one decoded frame pair.

        ``refine_only`` (the 'R' key) refines from the current extrinsic by
        ICP alone; otherwise FPFH + RANSAC find it and ICP refines it, from
        the RANSAC pose and from the identity. ``colored`` refines with
        colored ICP on camera 1's stride-2 cloud and intensity: on a flat
        textured wall point-to-plane leaves two in-plane translations and
        the in-plane rotation free, and the photometric term pins them to
        the texture.

        A pose passes when its overlap clears ``min_overlap_extrinsic``, at
        most ``FREE_SPACE_MAX_SHARE`` of either camera's pixels land in
        front of what the other measured, by a band that grows with the
        frames' own depth noise (``tracking.icp.free_space_shares``), and
        it is a proper rigid transform other than the identity. The
        candidate of best overlap is taken when it passes, the band at
        camera 0's median depth is at its 3 cm floor (a wider band lets a
        pose slid a few cm along the scene's planes pass) and at most
        ``FAST_PATH_MAX_SHARE`` of either camera's pixels land in front (a
        pose slid 1-2.5 cm passes the 3 cm band with 1-3 %). Otherwise each
        candidate is refined again by colored ICP (stage
        ``colored_refine``), the result with the fewest pixels in front
        once more, and of all that pass the one with the fewest pixels in
        front wins. When none passes, or a ``refine_only`` refinement
        fails, the extrinsic stays as it was, ``calib_reject``
        counts, and the warning names the checkerboard route."""
        reg = self.cfg.registration
        self.calib_stage_ms = {}
        t = time.perf_counter()
        clouds = []
        for i, f in enumerate(frames):
            pts = backproject_depth(f.depth, self.rays[i])[::4, ::4].reshape(-1, 3)
            ds, dm, _, _ = voxel_downsample_arrays(pts, pts[:, 2] > 0, 0.02, 8192)
            clouds.append((ds, remove_statistical_outliers(ds, dm, k=12, radius=0.06)))
        t = self._stage_done("downsample", t)
        (p0, m0), (p1, m1) = clouds
        tgt = TargetMaps.from_depth(frames[0].depth, self.rays[0],
                                    intensity=frames[0].intensity)

        def refine(init, colored):
            if colored:
                sp = backproject_depth(frames[1].depth, self.rays[1])[::2, ::2].reshape(-1, 3)
                si = frames[1].intensity[::2, ::2].reshape(-1)
                return colored_icp(sp, si, sp[:, 2] > 0, tgt, self.intr[0], init=init, cfg=reg)
            return icp_point_to_plane(p1, m1, tgt, self.intr[0], init=init, cfg=reg)

        def overlap(T):
            return evaluate_registration(p1, m1, p0, m0, T, dist_thr=0.03)[0]

        def passes(row, T01):
            return (row[0] >= reg.min_overlap_extrinsic
                    and row[1] <= FREE_SPACE_MAX_SHARE
                    and se3.is_valid_transform(T01)
                    and abs(np.trace(T01) - 4.0) >= 1e-6)  # the identity: degenerate

        band = free_space_band(frames[0].depth, frames[1].depth)
        refine_only = refine_only and self.extrinsics[1] is not None
        if refine_only:
            init = np.linalg.inv(self.extrinsics[0]) @ self.extrinsics[1]
            res = refine(torch.as_tensor(init, dtype=torch.float32).to(self.device), colored)
            t = self._stage_done("icp_refine", t)
            rows, host = self._score(frames, [res.T], [res.fitness], band)
            t = self._stage_done("evaluate", t)
        else:
            cam = np.zeros(3)  # normals face each camera's center
            n0 = estimate_normals_knn(p0, m0, radius=0.04, k=12, orient_to=cam)
            n1 = estimate_normals_knn(p1, m1, radius=0.04, k=12, orient_to=cam)
            t = self._stage_done("normals", t)
            f0 = compute_fpfh(p0, n0, m0, radius=0.06, k=16)
            f1 = compute_fpfh(p1, n1, m1, radius=0.06, k=16)
            t = self._stage_done("fpfh", t)
            # global_registration, split so that its two stages are timed
            corr = match_features(f1, f0, m1 & (f1.abs().sum(dim=1) > 0),
                                  m0 & (f0.abs().sum(dim=1) > 0))
            t = self._stage_done("match", t)
            g = ransac_registration(p1, p0, corr, reg, generator=self.generator)
            t = self._stage_done("ransac", t)
            # FPFH of flat or round surfaces is ambiguous, and RANSAC then
            # returns a pose that depends on its draw, from which the
            # refinement may not recover; so the identity (both cameras view
            # the scene) is refined as well
            poses = [refine(init, colored).T
                     for init in (g.T, torch.eye(4, device=self.device))]
            t = self._stage_done("icp_refine", t)
            rows, host = self._score(frames, poses, [overlap(T) for T in poses], band)
            t = self._stage_done("evaluate", t)
        k = int(np.argmax(rows[:, 0]))
        if not refine_only and (not passes(rows[k], host[k]) or rows[k, 3] > FREE_SPACE_BAND_M
                                or rows[k, 1] > FAST_PATH_MAX_SHARE):
            # point-to-plane slides planes along themselves and stops short in
            # a wide baseline's basin, and on noisy depth it settles cm off,
            # under a band the noise widened; the texture pins all three. From
            # a start 0.35 m off the iterations can run out cm short, so the
            # result with the fewest pixels in front starts a second pass
            starts = poses
            for _ in range(2):
                more = [refine(T, True).T for T in starts]
                t = self._stage_done("colored_refine", t)
                rows2, host2 = self._score(frames, more, [overlap(T) for T in more], band)
                t = self._stage_done("evaluate", t)
                rows, host = np.concatenate([rows, rows2]), host + host2
                starts = [more[int(np.argmin(rows2[:, 1]))]]
            ok = [i for i in range(len(host)) if passes(rows[i], host[i])]
            k = min(ok, key=lambda i: rows[i, 1]) if ok else int(np.argmin(rows[:, 1]))
        fit, front, agree, band_m = rows[k]
        T01 = host[k]
        self.calib_scores = {"overlap": fit, "in_front": front, "agree": agree, "band_m": band_m}
        if not passes(rows[k], T01):
            log.warning("calibration rejected: overlap %.2f (gate %.2f), %.2f %% of the pixels "
                        "more than %.1f cm in front of the other camera's surface (gate %.2f "
                        "%%), %.2f %% on it; %s", fit, reg.min_overlap_extrinsic, 100 * front,
                        100 * max(band_m, FREE_SPACE_BAND_M), 100 * FREE_SPACE_MAX_SHARE,
                        100 * agree, RIG_CALIB_ADVICE)
            self.telemetry.count("calib_reject")
            return False
        self.extrinsics[1] = self.extrinsics[0] @ T01
        self.calibrated = True
        r, p, y = np.degrees(se3.rpy_from_matrix(T01[:3, :3]))
        log.info("calibrated: overlap %.2f, %.2f %% in front, %.2f %% on the surface (band "
                 "%.1f cm), t = %s, rpy = (%.1f, %.1f, %.1f) deg", fit, 100 * front,
                 100 * agree, 100 * max(band_m, FREE_SPACE_BAND_M), T01[:3, 3], r, p, y)
        self.telemetry.count("calib_ok")
        return True

    def recalibrate(self) -> bool:
        """'R' key: ICP refinement of the current extrinsic on the last pair."""
        frames = self._decoded_frames()
        if None in frames:
            return False
        return self.calibrate(tuple(frames), refine_only=True, colored=self.colored_calibration)

    def _decoded_frames(self) -> List[Optional[RGBDFrame]]:
        """Decoded frames of the last pair, made on demand: the hot loop
        decodes inside its step, so display and recalibration decode here,
        at their own cadence."""
        if self._frames_stale:
            cam = self.cfg.camera
            self._last_frames = [
                None if r is None else RGBDFrame.from_raw(r[0], r[1], cam.depth_scale,
                                                          cam.depth_trunc, cam.depth_min)
                for r in self._last_raw]
            self._frames_stale = False
        return self._last_frames

    # -- streaming ----------------------------------------------------------------

    def process_frames(self, pair) -> None:
        """pair: ((depth0, color0), (depth1, color1)) raw u16/u8 arrays or tensors.

        Until calibration succeeds, the pair is also decoded and calibrated
        on (which waits on the device), and camera 1's depth is zeroed
        inside the step (``cam1_on = 0``), so it adds nothing. Once
        calibrated, nothing here waits on the device."""
        cam = self.cfg.camera
        self._last_raw = [(upload(d, self.device), upload(c, self.device)) for d, c in pair]
        self._frames_stale = True
        if not self.calibrated:
            self.calibrate(tuple(self._decoded_frames()), colored=self.colored_calibration)
        T1 = self.extrinsics[1] if self.calibrated else np.eye(4)
        host = np.concatenate([np.asarray(self.extrinsics[0]).reshape(-1),
                               np.asarray(T1).reshape(-1), [1.0, float(self.calibrated)]])
        # T0, T1, cam0_on and cam1_on in one transfer
        dev = upload(host.astype(np.float32), self.device)
        (d0r, c0r), (d1r, c1r) = self._last_raw
        scal = (1.0 / cam.depth_scale, cam.depth_min, cam.depth_trunc)
        with self.telemetry.time_block("step"):
            if self.sharded:
                self.volume = self._sharded_step(self.volume, (d0r, d1r), (c0r, c1r),
                                                 dev[:32].view(2, 4, 4), self.rays[0], dev[32:],
                                                 *scal)
            else:
                self.volume = self._step(self.volume, d0r, c0r, d1r, c1r, self.rays[0],
                                         self.rays[1], dev[:16].view(4, 4),
                                         dev[16:32].view(4, 4), *scal, dev[33])
        self.frame_index += 1
        self.telemetry.tick_frame()
        self.telemetry.maybe_report(extra=f"calibrated {self.calibrated} mode {self.color_mode}")

    def merged_cloud(self, max_points: int = 200000) -> PointCloudHost:
        """Both cameras' points in the world frame, voxel-downsampled to
        ``cfg.voxel_downsample``, colored by the active color mode."""
        pts_all, col_all, msk_all = [], [], []
        for i, f in enumerate(self._decoded_frames()):
            pose = self.extrinsics[i]
            if f is None or pose is None:
                continue
            flat = backproject_depth(f.depth, self.rays[i]).reshape(-1, 3)
            if self.color_mode == "depth_gradient":
                cols = depth_gradient_colors(f.depth, far=self.cfg.camera.depth_trunc)
            elif self.color_mode == "uniform":
                cols = torch.tensor(_UNIFORM_COLORS[i % 2], dtype=torch.float32,
                                    device=self.device).expand(flat.shape)
            else:
                cols = f.color
            T = torch.as_tensor(pose, dtype=torch.float32).to(self.device)
            pts_all.append(se3.transform_points(T, flat))
            col_all.append(cols.reshape(-1, 3))
            # validity from the camera-frame depth: an invalid pixel lands on
            # the camera center in the world frame, far from the origin for camera 1
            msk_all.append(flat[:, 2] > 0)
        if not pts_all:
            return PointCloudHost(points=np.zeros((0, 3), np.float32))
        dp, dm, dc, _ = voxel_downsample_arrays(torch.cat(pts_all), torch.cat(msk_all),
                                                self.cfg.voxel_downsample, max_points,
                                                colors=torch.cat(col_all))
        m = dm.cpu().numpy()
        return PointCloudHost(points=dp.cpu().numpy()[m], colors=dc.cpu().numpy()[m])

    def cycle_color_mode(self) -> str:
        i = self.COLOR_MODES.index(self.color_mode)
        self.color_mode = self.COLOR_MODES[(i + 1) % len(self.COLOR_MODES)]
        return self.color_mode

    def extraction_volume(self):
        """The volume meshing runs on: in sharded mode the shards combined
        (``parallel.sharded_volume.combine_shards``), so that cells on a
        shard boundary see their neighbors on other shards."""
        if self.sharded:
            return sv.combine_shards(self.volume, self.cfg.tsdf, self.mesh.shape["blk"])
        return self.volume

    def save_current_state(self, poisson: bool = False) -> dict:
        """'S' key: the merged cloud as PLY and the welded TSDF mesh as OBJ
        (timestamped and ``latest_*``); with ``poisson`` and Open3D
        installed, also a Poisson mesh of the merged cloud as OBJ. Returns
        {"pointcloud", "mesh"[, "poisson"]} paths."""
        paths = {}
        cloud = self.merged_cloud()
        if len(cloud):
            paths["pointcloud"] = self.saver.save_point_cloud(cloud, kind="merged")
        mesh = mc.weld_vertices(mc.extract_mesh(self.extraction_volume(), self.cfg.tsdf).compact())
        mesh.compute_vertex_normals()
        paths["mesh"] = self.saver.save_mesh(mesh, kind="mesh", obj=True)
        if poisson:
            pmesh = poisson_mesh_from_cloud(cloud)
            if pmesh is not None:
                paths["poisson"] = self.saver.save_mesh(pmesh, kind="poisson_mesh", obj=True)
        log.info("saved: %s", paths)
        return paths


def make_raw_dual_step(intr0: Intrinsics, intr1: Intrinsics, tcfg: TSDFConfig,
                       worklist_size: Optional[int] = None, stride: int = 2):
    """The two-camera hot path, fed raw sensor tensors on the device:

    step(vol, depth_raw0, color_raw0, depth_raw1, color_raw1, rays0, rays1,
         T0 (4, 4), T1 (4, 4), inv_scale, depth_min, depth_trunc, cam1_on)
        -> vol

    decode both frames, then allocate + worklist + integrate (B1) camera 0
    and camera 1 at their camera-to-world poses. ``cam1_on = 0`` zeroes
    camera 1's decoded depth, so it neither allocates nor integrates. The
    poses and the gate are tensors; nothing waits on the host, and the
    volume's pools update in place."""

    def step(vol, depth_raw0, color_raw0, depth_raw1, color_raw1, rays0, rays1, T0, T1,
             inv_scale, depth_min, depth_trunc, cam1_on):
        with full_fp32_matmul():
            d0, c0, _ = decode_raw_frame(depth_raw0, color_raw0, inv_scale, depth_min,
                                         depth_trunc)
            d1, c1, _ = decode_raw_frame(depth_raw1, color_raw1, inv_scale, depth_min,
                                         depth_trunc)
            d1 = d1 * cam1_on
            vol = integrate_step(vol, d0, c0, T0, rays0, intr0, tcfg, worklist_size, stride)
            return integrate_step(vol, d1, c1, T1, rays1, intr1, tcfg, worklist_size, stride)

    return step
