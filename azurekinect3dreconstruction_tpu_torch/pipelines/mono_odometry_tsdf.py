"""Single-camera streaming odometry + TSDF pipeline.

Per frame: decode the raw u16/u8 arrays, track hybrid RGB-D odometry
against the previous frame, gate it on fitness (identity motion on
failure), allocate blocks along the new depth's truncation band, build the
frustum worklist and integrate. In frame-to-model mode, projective
point-to-plane ICP against a surface sample of the fused model refines the
odometry pose before the frame is fused (:func:`make_raw_f2m_step`), which
bounds frame-to-frame drift; the sample is refreshed every few frames.

The pose, the gates and the trajectory stay on the device; the host only
enqueues work. The host views (``T_world_cam``, ``trajectory``,
``odometry_failures``, ``counts``) synchronize when read, at save or report
cadence, not per frame.
"""

from __future__ import annotations

import collections
from typing import Optional

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
from azurekinect3dreconstruction_tpu_torch.core.types import RGBDFrame, decode_raw_frame
from azurekinect3dreconstruction_tpu_torch.ops.kernels.odometry_kernels import (
    compute_odometry_fast,
)
from azurekinect3dreconstruction_tpu_torch.ops.kernels.tsdf_kernels import integrate_step
from azurekinect3dreconstruction_tpu_torch.tracking.icp import GraphedICP, TargetMaps
from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf

__all__ = ["MonoOdometryTSDF", "apply_odometry_gate", "decode_raw_frame",
           "integration_reach", "make_raw_batch_fn", "make_raw_f2m_step", "make_raw_slam_step"]

TRACKING_MODES = ("frame_to_frame", "frame_to_model")


def integration_reach(cfg: PipelineConfig) -> float:
    """Farthest block center a frame can touch: max depth times the
    diagonal-FOV secant (~1.45 for the Kinect NFOV corner rays), plus the
    truncation band, plus one block diagonal."""
    return 1.45 * cfg.camera.depth_trunc + cfg.tsdf.sdf_trunc + 1.8 * cfg.tsdf.block_size


class MonoOdometryTSDF:
    """Feed raw (depth_u16, color_u8) frames; poses accumulate from odometry.

    ``device`` is ``"cuda"`` (the hand-written kernels) or ``"cpu"`` (their
    plain PyTorch versions); ``"cuda"`` without a card raises.

    ``tracking``: ``"frame_to_frame"`` chains odometry; ``"frame_to_model"``
    lets odometry predict and projective ICP against ``model_points``
    surface samples of the fused model refine, gated on at least
    ``model_min_inliers`` inliers. The model is re-sampled every
    ``model_refine_interval`` frames from ``model_sample_blocks`` blocks near
    the camera; a run of accepted refinements stretches the interval up to
    twice, any rejection snaps it back."""

    MIN_FITNESS = 0.3  # odometry acceptance gate
    REFRESH_MARGIN = 0.25  # metres the camera may move before the next refresh

    def __init__(self, intrinsics: Intrinsics, config: Optional[PipelineConfig] = None, *,
                 device, tracking: str = "frame_to_frame", model_refine_interval: int = 5,
                 model_points: int = 32768, model_sample_blocks: int = 256,
                 model_min_inliers: int = 3000, worklist_size: int = 2048):
        if tracking not in TRACKING_MODES:
            raise ValueError(f"tracking must be one of {TRACKING_MODES}, got {tracking!r}")
        self.device = resolve_device(device)
        self.intr = intrinsics
        self.cfg = config or PipelineConfig()
        self.tracking = tracking
        self.model_refine_interval = model_refine_interval
        self.model_points = model_points
        self.model_sample_blocks = model_sample_blocks
        self.worklist_size = worklist_size
        self.rays = pixel_rays(intrinsics, self.device)
        self._step = make_raw_slam_step(intrinsics, self.cfg, worklist_size=worklist_size,
                                        stride=2, min_fitness=self.MIN_FITNESS)
        self._f2m_step = make_raw_f2m_step(intrinsics, self.cfg, worklist_size=worklist_size,
                                           stride=2, min_fitness=self.MIN_FITNESS,
                                           min_inliers=model_min_inliers)
        # before the first refresh, an all-false mask of the model's size:
        # the refinement gate rejects and the frame tracks by odometry alone
        m = 3 * max(model_points // 3, 1)  # the sampled model's size
        self._no_model = (torch.zeros((m, 3), dtype=torch.float32, device=self.device),
                          torch.zeros((m,), dtype=torch.bool, device=self.device))
        self.reset()

    def reset(self) -> None:
        """Drop the volume, the trajectory, the previous frame and the model."""
        self.volume = tsdf.create(self.cfg.tsdf, self.device)
        self._T = torch.eye(4, dtype=torch.float32, device=self.device)
        self._traj = [self._T]
        self._fits = []  # device fitness scalars, one per tracked frame
        self._prev_int = None  # intensity of the previous frame (device)
        self._prev_depth = None  # depth in meters of the previous frame (device)
        self.frame_index = 0
        self._model = None  # (points, mask) on the device
        self._counts = collections.Counter()
        self._icp_ok = []  # device refinement-gate flags not yet counted
        self._model_ovf = []  # device refresh-overflow flags not yet counted
        self._ok_pending = []  # (frame index, host copy of its gate flag, copy-done event)
        self._ok_streak = 0
        self._next_refresh = self.model_refine_interval

    # -- host views (each read synchronizes once) -----------------------------

    @property
    def T_world_cam(self) -> np.ndarray:
        """Current camera-to-world pose (host copy)."""
        return self._T.cpu().numpy().astype(np.float64)

    @property
    def trajectory(self):
        """All poses so far as host float64 arrays."""
        stacked = torch.stack(self._traj).cpu().numpy().astype(np.float64)
        return [stacked[i] for i in range(stacked.shape[0])]

    @property
    def fitness(self) -> np.ndarray:
        """Gate fitness of every tracked frame (-1 where the gate rejected)."""
        if not self._fits:
            return np.zeros((0,), np.float32)
        return torch.stack(self._fits).cpu().numpy()

    @property
    def odometry_failures(self) -> int:
        """Frames where tracking fell back to identity motion."""
        f = self.fitness
        return int(((f <= self.MIN_FITNESS) | ~np.isfinite(f)).sum())

    @property
    def counts(self) -> dict:
        """Frame-to-model event counts: ``model_icp_ok`` / ``model_icp_skip``
        (refinements the gate accepted / rejected) and ``model_truncated``
        (model refreshes whose sample overflowed its supplier rows). Reads
        the pending device flags in one synchronization."""
        for flags, yes, no in ((self._icp_ok, "model_icp_ok", "model_icp_skip"),
                               (self._model_ovf, "model_truncated", None)):
            if flags:
                f = torch.stack(flags).cpu().numpy()
                flags.clear()
                self._counts[yes] += int(f.sum())
                if no is not None:
                    self._counts[no] += int((~f).sum())
        return {k: v for k, v in self._counts.items() if v}

    # -- per frame --------------------------------------------------------------

    def _host_flag(self, flag):
        """Start a copy of a device bool to the host; (host tensor, event
        that completes with the copy, None on the CPU)."""
        if self.device.type != "cuda":
            return flag, None
        h = torch.empty((), dtype=torch.bool, pin_memory=True)
        h.copy_(flag, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return h, ev

    def process_frame(self, depth_raw, color_raw):
        """Track + fuse one frame; returns the device-resident camera-to-world
        pose used. Nothing here waits on the device."""
        cam = self.cfg.camera
        depth_raw, color_raw = upload(depth_raw, self.device), upload(color_raw, self.device)
        scal = (1.0 / cam.depth_scale, cam.depth_min, cam.depth_trunc)
        if self._prev_int is None:
            # first frame: integrate at the identity / world origin
            frame = RGBDFrame.from_raw(depth_raw, color_raw, cam.depth_scale,
                                       cam.depth_trunc, cam.depth_min)
            self.volume = tsdf.integrate_frame(self.volume, frame.depth, frame.color,
                                               self.rays, self._T, self.intr, self.cfg.tsdf)
            self._prev_int, self._prev_depth = frame.intensity, frame.depth
        elif self.tracking == "frame_to_model":
            mp, mm = self._model if self._model is not None else self._no_model
            (self.volume, self._T, fit, self._prev_int, self._prev_depth, _, ok) = \
                self._f2m_step(self.volume, self._T, self._prev_int, self._prev_depth,
                               depth_raw, color_raw, self.rays, mp, mm, *scal)
            self._fits.append(fit)
            if self._model is not None:
                self._icp_ok.append(ok)
                # the refresh cadence reads this flag >= 2 frames later
                self._ok_pending.append((self.frame_index, *self._host_flag(ok)))
        else:
            (self.volume, self._T, fit, self._prev_int, self._prev_depth) = self._step(
                self.volume, self._T, self._prev_int, self._prev_depth, depth_raw,
                color_raw, self.rays, *scal)
            self._fits.append(fit)
        self._traj.append(self._T)
        self.frame_index += 1
        if self.tracking == "frame_to_model":
            self._maybe_refresh_model()
        return self._T

    def _model_reach(self) -> float:
        """Radius of the view-local model sample: the integration reach plus
        the distance the camera may move before the next refresh."""
        return integration_reach(self.cfg) + self.REFRESH_MARGIN

    def _maybe_refresh_model(self) -> None:
        """Re-sample the model (:func:`tsdf.marching_cubes.
        extract_sampled_surface_model`) once the refresh is due. Gate flags
        of frames at least 2 behind, whose host copies have landed, feed the
        accept streak first: ``model_refine_interval`` accepts in a row
        stretch the interval by one frame, up to twice its base."""
        base = self.model_refine_interval
        if self.frame_index < self._next_refresh:
            return
        while self._ok_pending and self._ok_pending[0][0] <= self.frame_index - 2:
            _, flag, ev = self._ok_pending.pop(0)
            if ev is not None:
                ev.synchronize()  # landed long ago: returns at once
            self._ok_streak = self._ok_streak + 1 if bool(flag) else 0
        pts, mask, ovf = mc.extract_sampled_surface_model(
            self.volume, self.cfg.tsdf, self.model_points, self._T, self._model_reach(),
            sample_blocks=self.model_sample_blocks)
        self._model = (pts, mask)
        self._model_ovf.append(ovf)
        self._next_refresh = self.frame_index + base + min(self._ok_streak // base, base)

    def extract_mesh(self, **kw):
        """Scene mesh (:func:`tsdf.marching_cubes.extract_mesh`; budgets and
        ``auto_grow`` pass through)."""
        return mc.extract_mesh(self.volume, self.cfg.tsdf, **kw)

    def extract_point_cloud(self, **kw):
        """Surface point samples of the whole volume (host numpy)."""
        return tsdf.extract_point_cloud(self.volume, self.cfg.tsdf, **kw)


def apply_odometry_gate(T_prev, res, min_fitness: float):
    """Accept the odometry when fitness clears the bar AND the transform is
    finite, otherwise fall back to identity motion. Returns (T_world_cam,
    fitness), with fitness -1 where the gate rejected."""
    eye = torch.eye(4, dtype=torch.float32, device=T_prev.device)
    ok = (res.fitness > min_fitness) & torch.isfinite(res.T_target_source).all()
    T_rel = torch.where(ok, se3.inverse(res.T_target_source), eye)
    T = se3.compose_renormalized(T_prev, T_rel)
    return T, torch.where(ok, res.fitness, -1.0)


def make_raw_slam_step(intr: Intrinsics, cfg: PipelineConfig, worklist_size: int = 2048,
                       stride: int = 2, min_fitness: float = 0.3):
    """The live-loop step, fed raw sensor tensors on the device:

    step(vol, T_prev, prev_intensity, prev_depth, depth_raw, color_raw, rays,
         inv_scale, depth_min, depth_trunc)
        -> (vol, T_world_cam, fitness, intensity, depth_m)

    decode -> odometry (previous frame = source, this frame = target) ->
    gate -> allocate -> worklist -> integrate, with no host synchronization.
    The volume's pools are updated in place."""

    def step(vol, T_prev, prev_int, prev_depth, depth_raw, color_raw, rays,
             inv_scale, depth_min, depth_trunc):
        with full_fp32_matmul():
            d, c, inten = decode_raw_frame(depth_raw, color_raw, inv_scale, depth_min,
                                           depth_trunc)
            res = compute_odometry_fast(prev_int, prev_depth, inten, d, intr, cfg.odometry)
            T, fit = apply_odometry_gate(T_prev, res, min_fitness)
            vol = integrate_step(vol, d, c, T, rays, intr, cfg.tsdf, worklist_size, stride)
        return vol, T, fit, inten, d

    return step


def make_raw_batch_fn(intr: Intrinsics, tsdf_cfg: TSDFConfig, worklist_size: Optional[int] = None,
                      stride: int = 2):
    """Integration of raw frames at given poses, with no odometry (the
    offline bundle's reintegration):

    batch(vol, depth_raws (F, H, W), color_raws (F, H, W, 3), poses
          (F, 4, 4), rays, inv_scale, depth_min, depth_trunc) -> vol

    decode -> allocate -> worklist -> integrate (B1), once per frame, with
    no host synchronization; the pools update in place. A zero-depth frame
    integrates nothing. ``worklist_size`` defaults to the whole pool: B1
    bounds itself on the device by the live row count, so the whole-pool
    worklist costs what a compacted one does and no visible block is left
    out (a smaller size sets the sticky ``overflow`` flag instead)."""

    def batch(vol, depth_raws, color_raws, poses, rays, inv_scale, depth_min, depth_trunc):
        with full_fp32_matmul():
            for dr, cr, T in zip(depth_raws, color_raws, poses):
                d, c, _ = decode_raw_frame(dr, cr, inv_scale, depth_min, depth_trunc)
                vol = integrate_step(vol, d, c, T, rays, intr, tsdf_cfg, worklist_size, stride)
        return vol

    return batch


def make_raw_f2m_step(intr: Intrinsics, cfg: PipelineConfig, worklist_size: int = 2048,
                      stride: int = 2, min_fitness: float = 0.3, refine_iters: int = 10,
                      min_inliers: int = 3000, max_jump: float = 0.1):
    """Frame-to-model tracking, fed raw sensor tensors on the device:

    step(vol, T_prev, prev_int, prev_depth, depth_raw, color_raw, rays,
         model_pts (M, 3 world), model_mask (M,), inv_scale, depth_min,
         depth_trunc)
        -> (vol, T_world_cam, fit, intensity, depth_m, icp_inliers, icp_ok)

    decode -> odometry -> gate -> projective point-to-plane ICP of the
    model's world-frame samples onto this frame's organized maps, from
    ``inv(T_odo)`` -> refinement gate -> allocate -> worklist -> integrate at
    the pose the gate chose. The refinement is accepted on inlier count
    (most of a grown map lies outside one frame, so not on fitness), a
    finite transform, and a jump from the odometry pose under ``max_jump``
    on the se3 log; otherwise the odometry pose stands. An all-false
    ``model_mask`` rejects: pure odometry. Every gate is a ``torch.where``,
    so nothing waits on the host; the volume's pools update in place. On
    the card the ICP replays as one CUDA graph (:class:`tracking.icp.
    GraphedICP`), captured at the first call for each model size."""
    refine = GraphedICP(intr, refine_iters, cfg.registration.icp_distance_threshold)

    def step(vol, T_prev, prev_int, prev_depth, depth_raw, color_raw, rays, model_pts,
             model_mask, inv_scale, depth_min, depth_trunc):
        with full_fp32_matmul():
            d, c, inten = decode_raw_frame(depth_raw, color_raw, inv_scale, depth_min,
                                           depth_trunc)
            res = compute_odometry_fast(prev_int, prev_depth, inten, d, intr, cfg.odometry)
            T_odo, fit = apply_odometry_gate(T_prev, res, min_fitness)
            r = refine(model_pts, model_mask, TargetMaps.from_depth(d, rays), se3.inverse(T_odo))
            ok = (r.inliers >= min_inliers) & torch.isfinite(r.T).all()
            # the jump gate in the tangent space; a wild T must not poison it
            dlog = se3.se3_log(r.T @ T_odo)
            dlog = torch.where(torch.isfinite(dlog), dlog, 1e3)
            ok = ok & (torch.linalg.vector_norm(dlog) < max_jump)
            eye = torch.eye(4, dtype=torch.float32, device=T_odo.device)
            T = torch.where(ok, se3.compose_renormalized(se3.inverse(r.T), eye), T_odo)
            vol = integrate_step(vol, d, c, T, rays, intr, cfg.tsdf, worklist_size, stride)
        return vol, T, fit, inten, d, r.inliers, ok

    return step
