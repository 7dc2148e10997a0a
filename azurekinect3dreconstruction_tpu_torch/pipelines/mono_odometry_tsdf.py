"""Single-camera streaming odometry + TSDF pipeline (frame-to-frame mode).

Per frame: decode the raw u16/u8 arrays, track hybrid RGB-D odometry
against the previous frame, gate it on fitness (identity motion on
failure), allocate blocks along the new depth's truncation band, build the
frustum worklist and integrate. The pose, fitness gate and trajectory stay
on the device; the host only enqueues work. The host views
(``T_world_cam``, ``trajectory``, ``odometry_failures``) synchronize when
read, at save or report cadence, not per frame.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig
from azurekinect3dreconstruction_tpu_torch.core import se3
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device
from azurekinect3dreconstruction_tpu_torch.core.types import RGBDFrame, decode_raw_frame
from azurekinect3dreconstruction_tpu_torch.ops.kernels.odometry_kernels import (
    compute_odometry_fast,
)
from azurekinect3dreconstruction_tpu_torch.ops.kernels.tsdf_kernels import integrate_step
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf

__all__ = ["MonoOdometryTSDF", "apply_odometry_gate", "decode_raw_frame",
           "make_raw_slam_step"]


class MonoOdometryTSDF:
    """Feed raw (depth_u16, color_u8) frames; poses accumulate from odometry.

    ``device`` is ``"cuda"`` (the hand-written kernels) or ``"cpu"`` (their
    plain PyTorch versions); ``"cuda"`` without a card raises."""

    MIN_FITNESS = 0.3  # odometry acceptance gate

    def __init__(self, intrinsics: Intrinsics, config: Optional[PipelineConfig] = None, *,
                 device, worklist_size: int = 2048):
        self.device = resolve_device(device)
        self.intr = intrinsics
        self.cfg = config or PipelineConfig()
        self.worklist_size = worklist_size
        self.rays = pixel_rays(intrinsics, self.device)
        self._step = make_raw_slam_step(intrinsics, self.cfg, worklist_size=worklist_size,
                                        stride=2, min_fitness=self.MIN_FITNESS)
        self.reset()

    def reset(self) -> None:
        """Drop the volume, the trajectory and the previous frame."""
        self.volume = tsdf.create(self.cfg.tsdf, self.device)
        self._T = torch.eye(4, dtype=torch.float32, device=self.device)
        self._traj = [self._T]
        self._fits = []  # device fitness scalars, one per tracked frame
        self._prev_int = None  # intensity of the previous frame (device)
        self._prev_depth = None  # depth in meters of the previous frame (device)
        self.frame_index = 0

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

    # -- per frame --------------------------------------------------------------

    def _upload(self, a) -> torch.Tensor:
        """Host array -> device tensor without waiting on the device (a
        pinned staging copy, then an asynchronous transfer)."""
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        if t.device == self.device:
            return t
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def process_frame(self, depth_raw, color_raw):
        """Track + fuse one frame; returns the device-resident camera-to-world
        pose used. Nothing here waits on the device."""
        cam = self.cfg.camera
        depth_raw, color_raw = self._upload(depth_raw), self._upload(color_raw)
        if self._prev_int is None:
            # first frame: integrate at the identity / world origin
            frame = RGBDFrame.from_raw(depth_raw, color_raw, cam.depth_scale,
                                       cam.depth_trunc, cam.depth_min)
            self.volume = tsdf.integrate_frame(self.volume, frame.depth, frame.color,
                                               self.rays, self._T, self.intr, self.cfg.tsdf)
            self._prev_int, self._prev_depth = frame.intensity, frame.depth
        else:
            (self.volume, self._T, fit, self._prev_int, self._prev_depth) = self._step(
                self.volume, self._T, self._prev_int, self._prev_depth, depth_raw,
                color_raw, self.rays, 1.0 / cam.depth_scale, cam.depth_min, cam.depth_trunc)
            self._fits.append(fit)
        self._traj.append(self._T)
        self.frame_index += 1
        return self._T

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
        d, c, inten = decode_raw_frame(depth_raw, color_raw, inv_scale, depth_min,
                                       depth_trunc)
        res = compute_odometry_fast(prev_int, prev_depth, inten, d, intr, cfg.odometry)
        T, fit = apply_odometry_gate(T_prev, res, min_fitness)
        vol = integrate_step(vol, d, c, T, rays, intr, cfg.tsdf, worklist_size, stride)
        return vol, T, fit, inten, d

    return step
