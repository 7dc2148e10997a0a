"""Colored-ICP recording reconstructor, single camera (the counterpart of
the JAX package's ``pipelines/recorder.py``).

Recording toggles on and off (the 'R' key). While it is on, every frame is
fused into the TSDF and its pose recorded; every ``keyframe_interval``-th
frame is a keyframe, registered by colored ICP against the previous
keyframe's maps. Two steps cover every recorded frame
(:func:`make_raw_recorder_steps`), and neither waits on the host:

- the keyframe step: decode, a damped constant-velocity seed, colored ICP
  against the previous keyframe's target maps, the acceptance gate (accept,
  or keep the previous pose), integrate (B1), and this frame's maps;
- the interval step: decode and integrate (B1) at the held pose.

A rejected keyframe is caught later: its fitness copies to pinned host
memory as it is computed, and at the next keyframe (every
``fallback_check_keyframes`` keyframes) the host reads the copies, which
landed long before, and runs the fallback ladder on the saved raw frames:
FPFH + RANSAC ranked by cloud overlap, then a wide and a fine point-to-plane
ICP. A success rebases the pose chain; frames fused in between keep the
stale pose, the window in which the reference's own all-rungs-failed case
fuses with a stale pose too.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig
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
from azurekinect3dreconstruction_tpu_torch.ops.backproject import backproject_depth
from azurekinect3dreconstruction_tpu_torch.ops.image import sobel_gradients
from azurekinect3dreconstruction_tpu_torch.ops.kernels.tsdf_kernels import integrate_step
from azurekinect3dreconstruction_tpu_torch.ops.neighbors import (
    estimate_normals_knn,
    voxel_downsample_arrays,
)
from azurekinect3dreconstruction_tpu_torch.ops.normals import organized_normals
from azurekinect3dreconstruction_tpu_torch.tracking.features import compute_fpfh
from azurekinect3dreconstruction_tpu_torch.tracking.icp import (
    FREE_SPACE_MAX_SHARE,
    TargetMaps,
    free_space_band,
    free_space_shares,
    icp_point_to_plane,
    icp_projective,
)
from azurekinect3dreconstruction_tpu_torch.tracking.ransac import global_registration
from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import (
    Telemetry,
    log_info,
    log_warning,
)
from azurekinect3dreconstruction_tpu_torch.viz.savers import ResultSaver

_FALLBACK_ROUNDS = 8  # seed rounds the fallback ladder draws at most, while rejected


class Recorder:
    """Feed raw (depth_u16, color_u8) frames; ``toggle_recording`` starts
    and stops recording.

    ``device`` is ``"cuda"``, the default (kernel B1 on the card) or ``"cpu"``
    (its plain version); ``"cuda"`` without a card raises. ``worklist_size``
    defaults to the whole pool (the JAX package's 2,048 rows overflow once the
    interval frames' held poses have smeared the model over more visible
    blocks; B1 bounds itself by the live row count on the device, so the whole
    pool costs what a compacted worklist does). RANSAC draws from
    ``generator``, a ``torch.Generator`` on the device seeded with 0.
    ``telemetry`` counts the ladder's events (``colored_icp_ok``,
    ``colored_icp_reject``, ``fallback_icp_ok``, ``fallback_reject``,
    ``global_reject``, ``fallback_retry``, ``fallback_rebase``) and times
    the host side of each step (``keyframe``, ``integrate``, ``fallback``).
    ``ladder`` holds the last ladder run's refinements, each (T, fitness,
    share in front, whether it passed the gate), as the gate read them."""

    def __init__(self, intrinsics: Intrinsics, config: Optional[PipelineConfig] = None, *,
                 device="cuda", output_dir: str = "results", worklist_size: Optional[int] = None,
                 fallback_check_keyframes: int = 1):
        self.device = resolve_device(device)
        self.intr = intrinsics
        self.cfg = config or PipelineConfig()
        self.rays = pixel_rays(intrinsics, self.device)
        self.volume = tsdf.create(self.cfg.tsdf, self.device)
        self.fallback_check_keyframes = fallback_check_keyframes
        self._T = torch.eye(4, dtype=torch.float32, device=self.device)
        self._W_prev_kf = self._T  # pose at the previous keyframe
        self._traj = [self._T]  # recorded frames only
        self._maps = None  # the previous keyframe's target maps on the device
        self._kf_step, self._int_step = make_raw_recorder_steps(
            intrinsics, self.cfg, worklist_size=worklist_size)
        self.is_recording = False
        self.telemetry = Telemetry()
        self.saver = ResultSaver(output_dir)
        self.frame_index = 0
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self.ladder = []
        # per keyframe not yet checked: (host fitness, copy-done event, raw
        # previous keyframe, raw this keyframe, pose before it)
        self._pending = []
        self._last_kf_raw = None  # device raw (depth, color) of the last keyframe

    # -- host views (each read synchronizes) ---------------------------------

    @property
    def T_world_cam(self) -> np.ndarray:
        """Current camera-to-world pose (host float64)."""
        self._check_keyframes(force=True)
        return self._T.cpu().numpy().astype(np.float64)

    @property
    def trajectory(self) -> List[np.ndarray]:
        """Recorded poses as host float64 arrays."""
        self._check_keyframes(force=True)
        stacked = torch.stack(self._traj).cpu().numpy().astype(np.float64)
        return [stacked[i] for i in range(stacked.shape[0])]

    def toggle_recording(self) -> bool:
        self.is_recording = not self.is_recording
        if self.is_recording:
            # the next recorded frame seeds tracking afresh
            self._maps = None
            self._last_kf_raw = None
        else:
            self._check_keyframes(force=True)
        log_info(("started" if self.is_recording else "stopped") + " recording")
        return self.is_recording

    def _zero_maps(self):
        """Bootstrap maps: all-zero normals give zero correspondences, so the
        keyframe step's gate rejects and keeps the pose (the first frame's
        semantics) while it integrates and emits this frame's real maps."""
        H, W = self.intr.height, self.intr.width
        z3 = torch.zeros((H, W, 3), dtype=torch.float32, device=self.device)
        z1 = torch.zeros((H, W), dtype=torch.float32, device=self.device)
        return (z3, z3, z1, z1, z1)

    def _host_copy(self, t):
        """Start a copy of a device scalar to the host: (host tensor, event
        that completes with the copy; None on the CPU)."""
        if self.device.type != "cuda":
            return t, None
        h = torch.empty((), dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return h, ev

    def process_frame(self, depth_raw, color_raw):
        """Track + fuse one frame; returns the device-resident pose. Nothing
        here waits on the device, except the keyframe check, which reads
        fitness copies that landed a keyframe ago."""
        cam = self.cfg.camera
        scal = (1.0 / cam.depth_scale, cam.depth_min, cam.depth_trunc)
        if self.is_recording:
            raw = (upload(depth_raw, self.device), upload(color_raw, self.device))
            seeding = self._maps is None
            if seeding or self.frame_index % self.cfg.keyframe_interval == 0:
                if not seeding:
                    # before this keyframe's step, so that a rebase lands
                    # before the new registration composes on top of it
                    self._check_keyframes()
                W_before = self._T
                maps = self._zero_maps() if seeding else self._maps
                W_pp = self._T if seeding else self._W_prev_kf
                with self.telemetry.time_block("keyframe"):
                    (self.volume, self._T, fit, *maps) = self._kf_step(
                        self.volume, self._T, W_pp, *maps, *raw, self.rays, *scal)
                self._maps = tuple(maps)
                if not seeding:
                    self._pending.append((*self._host_copy(fit), self._last_kf_raw, raw,
                                          W_before))
                self._W_prev_kf = W_before
                self._last_kf_raw = raw
            else:
                with self.telemetry.time_block("integrate"):
                    self.volume = self._int_step(self.volume, self._T, *raw, self.rays, *scal)
            self._traj.append(self._T)
        self.frame_index += 1
        self.telemetry.tick_frame()
        self.telemetry.maybe_report(extra=f"mode {'REC' if self.is_recording else 'view'}")
        return self._T

    # -- deferred fallback ladder ---------------------------------------------

    def _check_keyframes(self, force: bool = False) -> None:
        """Read the pending keyframes' fitness copies and run the fallback
        ladder for each rejected one (fitness -1). Runs every
        ``fallback_check_keyframes`` keyframes, or now with ``force``."""
        if not self._pending:
            return
        if not force and len(self._pending) < self.fallback_check_keyframes:
            return
        pending, self._pending = self._pending, []
        for fit, ev, raw_prev, raw_curr, W_before in pending:
            if ev is not None:
                ev.synchronize()  # the copy landed long ago: returns at once
            if float(fit) >= 0:
                self.telemetry.count("colored_icp_ok")
                continue
            self.telemetry.count("colored_icp_reject")
            with self.telemetry.time_block("fallback"):
                T_cp = self._register_fallback(raw_prev, raw_curr)
            if T_cp is None:
                log_warning("registration failed; keeping previous pose")
                continue
            # had the ladder succeeded inline, the keyframe would have
            # applied T_cp where the gate applied the identity, and every
            # later composition right-multiplied: corrected = W_before @
            # T_cp @ W_before^-1 @ T_now (host float64)
            Wb = W_before.cpu().numpy().astype(np.float64)
            Tn = self._T.cpu().numpy().astype(np.float64)
            self._T = torch.as_tensor(Wb @ T_cp @ np.linalg.inv(Wb) @ Tn,
                                      dtype=torch.float32).to(self.device)
            self.telemetry.count("fallback_rebase")

    def _register_fallback(self, raw_prev, raw_curr) -> Optional[np.ndarray]:
        """The expensive rungs on the saved raw frames of a rejected
        keyframe: global FPFH + RANSAC registration, then point-to-plane ICP.
        Returns T (this camera -> previous keyframe camera, host float64) or
        None. The reference's whole ladder is one round: 4 RANSAC restarts,
        the one of most cloud overlap refined. Here every restart is refined
        and the refinement of highest fitness wins, once it passes the gate
        and a second refinement lands on the same pose: on the card, the
        jump of ``tests/test_pipelines.py`` once refined from the restart of
        most overlap to a pose 0.63 m and 0.57 rad off that passed the gate
        (a seed slid along a plane keeps much of its overlap), while the
        true pose fits better. A restart lands in ICP's basin only on some
        draws (and on the card every run is a new draw: the downsample's and
        FPFH's scatter-adds are atomics), so while no winner is accepted,
        another round draws fresh seeds, at most ``_FALLBACK_ROUNDS`` in all;
        the last round accepts an unconfirmed winner that passes the gate.
        The gate is the fitness and free space: at most
        ``FREE_SPACE_MAX_SHARE`` of either frame's pixels may land in front
        of the other's surface (``tracking.icp.free_space_shares``, the band
        from the frames' own noise). On the card at 1280x720 a round once
        confirmed a pose 0.20 m and 0.18 rad off: a pose slid past the
        scene can fit nearly as well as the true one, but it leaves far
        more of the pixels in front."""
        cam = self.cfg.camera
        reg = self.cfg.registration
        # the recovery stage gets the full hypothesis pool
        reg_full = dataclasses.replace(reg, ransac_hypotheses=max(8192, reg.ransac_hypotheses))
        prev = RGBDFrame.from_raw(*raw_prev, cam.depth_scale, cam.depth_trunc, cam.depth_min)
        curr = RGBDFrame.from_raw(*raw_curr, cam.depth_scale, cam.depth_trunc, cam.depth_min)
        prev_maps = TargetMaps.from_depth(prev.depth, self.rays, intensity=prev.intensity)
        stride = 4  # a 2-D grid subsample: a flat [::16] would keep every 16th column only
        src = backproject_depth(curr.depth, self.rays)[::stride, ::stride].reshape(-1, 3)
        s_mask = src[:, 2] > 0
        # 1.5 cm grid, 2x / 4x-voxel normal / feature radii, 4 cm RANSAC threshold
        vox = 0.015
        ds, dm, _, _ = voxel_downsample_arrays(src, s_mask, vox, 8192)
        tgt_pts = prev_maps.points[::stride, ::stride].reshape(-1, 3)
        dt, dtm, _, _ = voxel_downsample_arrays(tgt_pts, tgt_pts[:, 2] > 0, vox, 8192)
        n_s = estimate_normals_knn(ds, dm, radius=2 * vox, k=12, orient_to=np.zeros(3))
        n_t = estimate_normals_knn(dt, dtm, radius=2 * vox, k=12, orient_to=np.zeros(3))
        f_s = compute_fpfh(ds, n_s, dm, radius=4 * vox, k=16)
        f_t = compute_fpfh(dt, n_t, dtm, radius=4 * vox, k=16)
        wide = dataclasses.replace(reg, icp_distance_threshold=3 * reg.icp_distance_threshold)
        band = free_space_band(prev.depth, curr.depth)
        self.ladder = []

        def passes(r) -> bool:
            """The fitness and free-space gate (one host read), logged to
            ``ladder``."""
            front = torch.maximum(
                free_space_shares(prev.depth, self.intr, curr.depth, self.rays, r.T, band)[0],
                free_space_shares(curr.depth, self.intr, prev.depth, self.rays,
                                  se3.inverse(r.T), band)[0])
            fit, front = torch.stack([r.fitness.to(front.dtype), front]).tolist()
            T = r.T.cpu().numpy().astype(np.float64)
            ok = (fit >= reg.min_fitness_icp and front <= FREE_SPACE_MAX_SHARE
                  and se3.is_valid_transform(T))
            self.ladder.append((T, fit, front, ok))
            return ok

        refined = []  # every refinement so far, of every round, that passes the gate
        drawn = False  # whether any restart gave a transform to refine
        for k in range(_FALLBACK_ROUNDS):
            if k:
                self.telemetry.count("fallback_retry")
            for _ in range(4):
                g = global_registration(ds, f_s, dm, dt, f_t, dtm, reg_full,
                                        distance_threshold=0.04, generator=self.generator)
                if not se3.is_valid_transform(g.T.cpu().numpy()):
                    continue
                # RANSAC only seeds: the refinement pulls a seed several cm
                # off into the basin, and its fitness is what decides
                r1 = icp_point_to_plane(src, s_mask, prev_maps, self.intr, init=g.T, cfg=wide)
                r2 = icp_point_to_plane(src, s_mask, prev_maps, self.intr, init=r1.T, cfg=reg)
                drawn = True
                if passes(r2):
                    refined.append(r2)
            if not refined:
                continue
            best = max(refined, key=lambda r: float(r.fitness))
            n_same = sum(se3.same_pose(r.T, best.T, reg.icp_distance_threshold) for r in refined)
            if n_same >= 2 or k == _FALLBACK_ROUNDS - 1:
                self.telemetry.count("fallback_icp_ok")
                return best.T.cpu().numpy().astype(np.float64)
        self.telemetry.count("fallback_reject" if drawn else "global_reject")
        return None

    # -- persistence ----------------------------------------------------------

    def save_model(self, weld: bool = True) -> dict:
        """The mesh (PLY), the volume's surface points (PLY) and the
        trajectory; returns their paths."""
        self._check_keyframes(force=True)
        mesh = mc.extract_mesh(self.volume, self.cfg.tsdf).compact()
        if weld:
            mesh = mc.weld_vertices(mesh)
        mesh.compute_vertex_normals()
        paths = {"mesh": self.saver.save_mesh(mesh, kind="mesh")}
        pts, cols = tsdf.extract_point_cloud(self.volume, self.cfg.tsdf)
        paths["pointcloud"] = self.saver.save_point_cloud(PointCloudHost(points=pts, colors=cols),
                                                          kind="volume_pcd")
        paths["trajectory"] = self.saver.save_trajectory(self.trajectory)
        log_info(f"saved model: {paths}")
        return paths


def make_raw_recorder_steps(intr: Intrinsics, cfg: PipelineConfig,
                            worklist_size: Optional[int] = None, stride: int = 2,
                            src_stride: int = 4, damping: float = 0.9):
    """The Recorder's two steps, fed raw sensor tensors on the device:

    kf_step(vol, T_world, W_prev_kf, tgt_pts, tgt_nrm, tgt_int, tgt_gu,
            tgt_gv, depth_raw, color_raw, rays, inv_scale, depth_min,
            depth_trunc)
        -> (vol, T_world', fit, pts, nrm, inten, gu, gv)

    decode -> constant-velocity seed ``exp(damping * log(inv(W_prev_kf) @
    T_world))`` (the identity where the log is not finite) -> colored ICP
    of this frame's ``src_stride``-subsampled cloud against the previous
    keyframe's maps -> gate (fitness >= ``min_fitness_colored`` and a finite
    transform, else the identity) -> compose -> allocate + worklist +
    integrate (B1) -> this frame's maps for the next keyframe. ``fit`` is
    the colored-ICP fitness, or -1 where the gate rejected.

    int_step(vol, T_world, depth_raw, color_raw, rays, inv_scale,
             depth_min, depth_trunc) -> vol

    decode -> allocate + worklist + integrate (B1) at the held pose.

    Every gate is a ``torch.where``: neither step waits on the host, and
    the volume's pools update in place. ``worklist_size`` None is the whole
    pool; a smaller one sets the sticky ``overflow`` flag when more blocks
    are visible."""
    reg = cfg.registration
    tcfg = cfg.tsdf

    def kf_step(vol, T_world, W_prev_kf, tgt_pts, tgt_nrm, tgt_int, tgt_gu, tgt_gv, depth_raw,
                color_raw, rays, inv_scale, depth_min, depth_trunc):
        with full_fp32_matmul():
            d, c, inten = decode_raw_frame(depth_raw, color_raw, inv_scale, depth_min,
                                           depth_trunc)
            pts = backproject_depth(d, rays)
            src = pts[::src_stride, ::src_stride].reshape(-1, 3)
            s_int = inten[::src_stride, ::src_stride].reshape(-1)
            xi = se3.se3_log(se3.inverse(W_prev_kf) @ T_world) * damping
            T_pred = se3.se3_exp(torch.where(torch.isfinite(xi).all(), xi, 0.0))
            tgt = TargetMaps(points=tgt_pts, normals=tgt_nrm, intensity=tgt_int, grad_u=tgt_gu,
                             grad_v=tgt_gv)
            res = icp_projective(src, src[:, 2] > 0, tgt, intr, init=T_pred,
                                 max_iters=reg.colored_icp_max_iters,
                                 dist_thr=reg.icp_distance_threshold,
                                 lambda_geometric=reg.colored_icp_lambda_geometric,
                                 colored=True, src_intensity=s_int)
            ok = (res.fitness >= reg.min_fitness_colored) & torch.isfinite(res.T).all()
            T_cp = torch.where(ok, res.T, torch.eye(4, dtype=torch.float32, device=d.device))
            T_new = se3.compose_renormalized(T_world, T_cp)
            vol = integrate_step(vol, d, c, T_new, rays, intr, tcfg, worklist_size, stride)
            gu, gv = sobel_gradients(inten)
            fit = torch.where(ok, res.fitness, -1.0)
        return vol, T_new, fit, pts, organized_normals(pts), inten, gu, gv

    def int_step(vol, T_world, depth_raw, color_raw, rays, inv_scale, depth_min, depth_trunc):
        with full_fp32_matmul():
            d, c, _ = decode_raw_frame(depth_raw, color_raw, inv_scale, depth_min, depth_trunc)
            return integrate_step(vol, d, c, T_world, rays, intr, tcfg, worklist_size, stride)

    return kf_step, int_step
