"""Single-camera streaming odometry + TSDF pipeline.

Per frame: decode the raw u16/u8 arrays, track hybrid RGB-D odometry
against the previous frame, gate it on fitness (identity motion on
failure), allocate blocks along the new depth's truncation band, build the
frustum worklist and integrate. In frame-to-model mode, projective
point-to-plane ICP against a surface sample of the fused model refines the
odometry pose before the frame is fused (:func:`make_raw_f2m_step`), which
bounds frame-to-frame drift; the sample is refreshed every few frames. With
``relocalize`` the step carries a device-side fusion latch
(:func:`apply_lost_latch`), and a lost pose is recovered against the fused
model (:class:`tracking.relocalize.Relocalizer`). With ``streaming`` the
volume is the pool of a :class:`tsdf.streaming.StreamingTSDF`, which moves
far blocks to host memory and back, so a scan of any extent fits the pool.

The pose, the gates and the trajectory stay on the device; the host only
enqueues work. The host views (``T_world_cam``, ``trajectory``,
``odometry_failures``, ``counts``) synchronize when read, at save or report
cadence, not per frame; relocalization adds one read every
``reloc_interval`` frames.
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
from azurekinect3dreconstruction_tpu_torch.tracking.relocalize import Relocalizer
from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import StreamingTSDF, integration_reach
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info, log_warning

__all__ = ["MonoOdometryTSDF", "apply_lost_latch", "apply_odometry_gate", "decode_raw_frame",
           "integration_reach", "make_raw_batch_fn", "make_raw_f2m_step", "make_raw_slam_step"]

TRACKING_MODES = ("frame_to_frame", "frame_to_model")


class MonoOdometryTSDF:
    """Feed raw (depth_u16, color_u8) frames; poses accumulate from odometry.

    ``device`` is ``"cuda"``, the default (the hand-written kernels) or
    ``"cpu"`` (their plain PyTorch versions); ``"cuda"`` without a card raises.

    ``tracking``: ``"frame_to_frame"`` chains odometry; ``"frame_to_model"``
    lets odometry predict and projective ICP against ``model_points``
    surface samples of the fused model refine, gated on at least
    ``model_min_inliers`` inliers. The model is re-sampled every
    ``model_refine_interval`` frames from ``model_sample_blocks`` blocks near
    the camera; a run of accepted refinements stretches the interval up to
    twice, any rejection snaps it back.

    ``relocalize`` (frame-to-frame only; ``ValueError`` otherwise): the step
    carries a device-side fusion latch that sets at the first gate
    rejection (:func:`apply_lost_latch`). Every ``reloc_interval`` frames
    the host reads the fitness scalars since the last check in one copy;
    ``reloc_window`` rejections in a row declare the pose lost, after which
    frames bypass the step and a :class:`tracking.relocalize.Relocalizer`
    (gated on ``reloc_min_inliers``) tries every ``reloc_interval``-th lost
    frame against the fused model, with the stale pose as its hint, until it
    recovers. ``reloc_warmup`` runs :meth:`Relocalizer.warmup` at
    construction. ``counts`` gains ``tracking_lost``, ``relocalized``,
    ``reloc_failed`` and ``fusion_paused_frames``.

    ``streaming``: a :class:`tsdf.streaming.StreamingTSDF` with the
    pipeline's ``TSDFConfig`` on its device (``ValueError`` otherwise). The
    pipeline adopts its pool as its one volume and hands the volume to its
    policy after every frame (:meth:`StreamingTSDF.maybe_tick`, which waits
    on the device only at the interval frame), adopting the pool a tick
    replaced; lost frames keep ticking at the stale pose, so geometry near
    the loss can stream back for the relocalizer. ``extract_mesh`` and
    ``extract_point_cloud`` then assemble live and streamed geometry."""

    MIN_FITNESS = 0.3  # odometry acceptance gate
    REFRESH_MARGIN = 0.25  # metres the camera may move before the next refresh

    def __init__(self, intrinsics: Intrinsics, config: Optional[PipelineConfig] = None, *,
                 device="cuda", tracking: str = "frame_to_frame", model_refine_interval: int = 5,
                 model_points: int = 32768, model_sample_blocks: int = 256,
                 model_min_inliers: int = 3000, worklist_size: int = 2048,
                 streaming: Optional[StreamingTSDF] = None,
                 relocalize: bool = False, reloc_window: int = 3, reloc_interval: int = 8,
                 reloc_min_inliers: int = 2000, reloc_warmup: bool = False):
        if tracking not in TRACKING_MODES:
            raise ValueError(f"tracking must be one of {TRACKING_MODES}, got {tracking!r}")
        if relocalize and tracking != "frame_to_frame":
            raise ValueError("relocalize requires tracking='frame_to_frame' (its step carries "
                             "the fusion latch)")
        self.device = resolve_device(device)
        self.intr = intrinsics
        self.cfg = config or PipelineConfig()
        if streaming is not None:
            if streaming.cfg != self.cfg.tsdf:
                raise ValueError("the streaming manager must share the pipeline's TSDFConfig")
            if streaming.vol.tsdf.device.type != self.device.type:
                raise ValueError(f"the streaming pool is on {streaming.vol.tsdf.device}, "
                                 f"the pipeline on {self.device}")
        self.streaming = streaming
        self.tracking = tracking
        self.model_refine_interval = model_refine_interval
        self.model_points = model_points
        self.model_sample_blocks = model_sample_blocks
        self.worklist_size = worklist_size
        self.rays = pixel_rays(intrinsics, self.device)
        self.relocalize = relocalize
        self.reloc_window = reloc_window
        self.reloc_interval = reloc_interval
        self.reloc_min_inliers = reloc_min_inliers
        self._relocalizer = None
        self._step = make_raw_slam_step(intrinsics, self.cfg, worklist_size=worklist_size,
                                        stride=2, min_fitness=self.MIN_FITNESS,
                                        integrate_rejected=not relocalize)
        self._f2m_step = make_raw_f2m_step(intrinsics, self.cfg, worklist_size=worklist_size,
                                           stride=2, min_fitness=self.MIN_FITNESS,
                                           min_inliers=model_min_inliers)
        # before the first refresh, an all-false mask of the model's size:
        # the refinement gate rejects and the frame tracks by odometry alone
        m = 3 * max(model_points // 3, 1)  # the sampled model's size
        self._no_model = (torch.zeros((m, 3), dtype=torch.float32, device=self.device),
                          torch.zeros((m,), dtype=torch.bool, device=self.device))
        self._reset_state()
        if relocalize and reloc_warmup:
            self._get_relocalizer().warmup()

    def reset(self) -> None:
        """Drop the volume (with ``streaming``, the manager's pool, store and
        caches), the trajectory, the previous frame, the model and the
        tracking-loss state."""
        if self.streaming is not None:
            self.streaming.reset_state()
        self._reset_state()

    def _reset_state(self) -> None:
        self.volume = (tsdf.create(self.cfg.tsdf, self.device) if self.streaming is None
                       else self.streaming.vol)
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
        self.lost = False  # the pose is declared untrusted
        self._lost = torch.zeros((), dtype=torch.float32, device=self.device)  # device latch
        self._lost_frames = 0  # frames since the loss was declared
        self._consec_fail = 0  # gate rejections in a row, as the checks saw them
        self._latch_up = False  # host mirror of the device latch
        self._paused_pending = 0  # latched frames not yet counted
        self._fit_checked = 0  # fitness scalars already read by a check

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
        """Event counts: frame-to-model's ``model_icp_ok`` / ``model_icp_skip``
        (refinements the gate accepted / rejected) and ``model_truncated``
        (model refreshes whose sample overflowed its supplier rows), read
        from the pending device flags in one synchronization; and
        relocalization's ``tracking_lost``, ``relocalized``, ``reloc_failed``
        and ``fusion_paused_frames`` (tracked frames the latch kept out of
        the volume without a loss being declared)."""
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
        pose used. Nothing here waits on the device, except relocalization's
        check every ``reloc_interval`` frames and its lost frames."""
        if self.lost:
            return self._process_lost(depth_raw, color_raw)
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
            args = (self.volume, self._T, self._prev_int, self._prev_depth, depth_raw, color_raw,
                    self.rays, *scal)
            if self.relocalize:
                (self.volume, self._T, fit, self._prev_int, self._prev_depth,
                 self._lost) = self._step(*args, self._lost)
            else:
                (self.volume, self._T, fit, self._prev_int, self._prev_depth) = self._step(*args)
            self._fits.append(fit)
        self._traj.append(self._T)
        self.frame_index += 1
        if self.relocalize and self.frame_index % self.reloc_interval == 0:
            self._check_tracking()
        if not self.lost:
            self._stream()
        if self.tracking == "frame_to_model":
            self._maybe_refresh_model()
        return self._T

    def _stream(self) -> None:
        """Hand the volume to the streaming policy (one frame of its
        interval) and adopt the pool a tick may have replaced: the kernels
        write the pools in place, so the pipeline must never keep a pool the
        manager dropped."""
        if self.streaming is not None:
            self.streaming.vol = self.volume
            if self.streaming.maybe_tick(lambda: self._T):
                self.volume = self.streaming.vol

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

    # -- tracking loss and relocalization (relocalize mode) --------------------

    def _get_relocalizer(self) -> Relocalizer:
        if self._relocalizer is None:
            self._relocalizer = Relocalizer(self.intr, self.cfg, device=self.device, rays=self.rays,
                                            model_points=self.model_points,
                                            min_inliers=self.reloc_min_inliers)
        return self._relocalizer

    def _check_tracking(self) -> None:
        """The check every ``reloc_interval`` frames: read the fitness
        scalars since the last check in one copy and scan them for rejection
        streaks. The worst streak in the window decides, not the trailing
        one: a ``reloc_window``-long streak that ended before the check has
        already corrupted the pose chain (frame-to-frame odometry re-locks
        against a corrupt previous frame), so the pose is lost even if the
        last frames passed the gate. Otherwise the latch reopens only when
        the window ends outside a streak: a streak that reaches the check may
        still be growing, and reopening now would let a gate-passing corrupt
        re-lock fuse before the next check. The paused frames are counted
        when the streak resolves."""
        fresh = self._fits[self._fit_checked:]
        self._fit_checked = len(self._fits)
        if not fresh:
            return
        f = torch.stack(fresh).cpu().numpy()
        bad = (f <= self.MIN_FITNESS) | ~np.isfinite(f)
        streak = worst = self._consec_fail
        for b in bad:
            streak = streak + 1 if b else 0
            worst = max(worst, streak)
        self._consec_fail = streak
        # the host mirror of the device latch, which sets at the first
        # rejected frame and which only the host clears
        if self._latch_up:
            self._paused_pending += len(bad)
        elif bad.any():
            self._latch_up = True
            self._paused_pending += len(bad) - int(np.argmax(bad))
        if worst >= self.reloc_window:
            self.lost = True
            self._lost_frames = 0
            self._paused_pending = 0  # these frames belong to the lost episode now
            self._counts["tracking_lost"] += 1
            log_warning(f"tracking LOST ({worst} consecutive rejections); fusion paused, "
                        "relocalizing")
        elif self._latch_up:
            if bad[-1]:
                log_info(f"tracking rejection streak ({streak}) reaches the check boundary: "
                         "fusion stays paused")
            else:
                self._counts["fusion_paused_frames"] += self._paused_pending
                log_info(f"transient tracking rejection: {self._paused_pending} frame(s) "
                         "tracked but not fused")
                self._paused_pending = 0
                self._latch_up = False
                self._lost = torch.zeros((), dtype=torch.float32, device=self.device)

    def _process_lost(self, depth_raw, color_raw):
        """A frame while the pose is lost: the step is bypassed (no odometry
        against a corrupt chain, no fusion) and the stale pose repeats in the
        trajectory. Every ``reloc_interval``-th lost frame, starting with the
        first, attempts a relocalization with the stale pose as the hint; a
        recovered frame integrates (B1) at its pose, re-seeds frame-to-frame
        tracking and clears every latch. A lost frame records fitness -1, the
        recovered one +1."""
        cam = self.cfg.camera
        # keep streaming at the stale pose, the loss site: the relocalizer's
        # model is built from resident blocks only, so geometry evicted near
        # the loss must be able to stream back (fusion is paused, so at most
        # one eviction runs while lost)
        self._stream()
        recovered = False
        if self._lost_frames % self.reloc_interval == 0:
            frame = RGBDFrame.from_raw(upload(depth_raw, self.device),
                                       upload(color_raw, self.device), cam.depth_scale,
                                       cam.depth_trunc, cam.depth_min)
            T = self._get_relocalizer().attempt(self.volume, frame.depth,
                                                T_hint=self.T_world_cam)
            if T is None:
                self._counts["reloc_failed"] += 1
            else:
                self._T = torch.as_tensor(T, dtype=torch.float32).to(self.device)
                self.volume = tsdf.integrate_frame(self.volume, frame.depth, frame.color,
                                                   self.rays, self._T, self.intr, self.cfg.tsdf)
                self._prev_int, self._prev_depth = frame.intensity, frame.depth
                self.lost = False
                self._lost = torch.zeros((), dtype=torch.float32, device=self.device)
                self._consec_fail = 0
                self._latch_up = False
                self._paused_pending = 0
                recovered = True
                self._counts["relocalized"] += 1
                log_info(f"relocalized after {self._lost_frames + 1} lost frames")
        self._lost_frames += 1
        self._fits.append(torch.full((), 1.0 if recovered else -1.0, dtype=torch.float32,
                                     device=self.device))
        self._fit_checked = len(self._fits)  # the checks must not count these again
        self._traj.append(self._T)
        self.frame_index += 1
        return self._T

    def extract_mesh(self, **kw):
        """Scene mesh (:func:`tsdf.marching_cubes.extract_mesh`; budgets and
        ``auto_grow`` pass through). With ``streaming`` the manager
        assembles live and frozen geometry into a host soup and takes only
        ``max_cells`` / ``max_tris`` (floors that only grow; ``ValueError``
        for anything else: a truncated extraction would break the frozen
        soups' exactness)."""
        if self.streaming is None:
            return mc.extract_mesh(self.volume, self.cfg.tsdf, **kw)
        extra = set(kw) - {"max_cells", "max_tris"}
        if extra:
            raise ValueError(f"unsupported with streaming: {sorted(extra)} (budgets only grow; "
                             "a truncated extraction would break the frozen soups)")
        self.streaming.vol = self.volume
        mesh = self.streaming.extract_mesh(max_cells=kw.get("max_cells"),
                                           max_tris=kw.get("max_tris"))
        self.volume = self.streaming.vol  # the refresh may have reloaded
        return mesh

    def extract_point_cloud(self, **kw):
        """Surface point samples of the whole volume (host numpy); with
        ``streaming`` the stored blocks' points are included."""
        if self.streaming is None:
            return tsdf.extract_point_cloud(self.volume, self.cfg.tsdf, **kw)
        self.streaming.vol = self.volume
        return self.streaming.extract_point_cloud(**kw)


def apply_odometry_gate(T_prev, res, min_fitness: float):
    """Accept the odometry when fitness clears the bar AND the transform is
    finite, otherwise fall back to identity motion. Returns (T_world_cam,
    fitness), with fitness -1 where the gate rejected."""
    eye = torch.eye(4, dtype=torch.float32, device=T_prev.device)
    ok = (res.fitness > min_fitness) & torch.isfinite(res.T_target_source).all()
    T_rel = torch.where(ok, se3.inverse(res.T_target_source), eye)
    T = se3.compose_renormalized(T_prev, T_rel)
    return T, torch.where(ok, res.fitness, -1.0)


def apply_lost_latch(lost_in, fit, depth):
    """The device-side fusion latch of relocalize mode: ``lost`` sets on any
    gate rejection (``fit < 0``) and only the host clears it, so from the
    first rejected frame on nothing fuses until the pose is proven again,
    gate-passing frames with a corrupt pose included. The depth is scaled to
    zero while latched: allocate then adds nothing and no voxel's update
    mask is set, with no branch. Returns (lost, depth to fuse)."""
    lost = torch.maximum(torch.as_tensor(lost_in, dtype=torch.float32, device=fit.device),
                         (fit < 0).to(torch.float32))
    return lost, depth * (1.0 - lost)


def make_raw_slam_step(intr: Intrinsics, cfg: PipelineConfig, worklist_size: int = 2048,
                       stride: int = 2, min_fitness: float = 0.3,
                       integrate_rejected: bool = True):
    """The live-loop step, fed raw sensor tensors on the device:

    step(vol, T_prev, prev_intensity, prev_depth, depth_raw, color_raw, rays,
         inv_scale, depth_min, depth_trunc)
        -> (vol, T_world_cam, fitness, intensity, depth_m)

    decode -> odometry (previous frame = source, this frame = target) ->
    gate -> allocate -> worklist -> integrate, with no host synchronization.
    The volume's pools are updated in place.

    ``integrate_rejected=False`` (relocalize mode): the step takes a trailing
    ``lost_in`` (a 0-d float32 tensor on the device), applies
    :func:`apply_lost_latch` between the gate and the integrate, and returns
    ``lost`` last. A latched frame still tracks, and B1 still launches once,
    with nothing to update."""

    def step(vol, T_prev, prev_int, prev_depth, depth_raw, color_raw, rays,
             inv_scale, depth_min, depth_trunc, *lost_in):
        with full_fp32_matmul():
            d, c, inten = decode_raw_frame(depth_raw, color_raw, inv_scale, depth_min,
                                           depth_trunc)
            res = compute_odometry_fast(prev_int, prev_depth, inten, d, intr, cfg.odometry)
            T, fit = apply_odometry_gate(T_prev, res, min_fitness)
            if integrate_rejected:
                vol = integrate_step(vol, d, c, T, rays, intr, cfg.tsdf, worklist_size, stride)
                return vol, T, fit, inten, d
            lost, d_fuse = apply_lost_latch(*lost_in, fit, d)
            vol = integrate_step(vol, d_fuse, c, T, rays, intr, cfg.tsdf, worklist_size, stride)
        return vol, T, fit, inten, d, lost

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
