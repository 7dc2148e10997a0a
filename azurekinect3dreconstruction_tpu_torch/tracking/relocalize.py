"""Tracking-loss recovery: re-register one frame against the fused model
(the counterpart of the JAX package's ``tracking/relocalize.py``).

When tracking is declared lost, the incoming frame is registered against
surface samples of the fused TSDF, not against the previous frame, whose
pose chain is no longer trusted. An attempt climbs a ladder:

0. the hint rung: with a pose hint (the loss site: the camera usually
   reappears near where it was lost), coarse-to-fine projective model ICP
   seeded by the hint, before any descriptors. It needs no FPFH, so it
   works on feature-poor geometry. No feature consensus backs the seed, so
   its gate is strict: the inlier count, a valid transform, a projective
   overlap of matched over visible model points of at least
   ``hint_gate_fitness`` (the overlap gate), and the slide gate below;
1. the model cloud: budget-bounded marching-cubes vertex samples
   (``marching_cubes.extract_surface_samples``), in world coordinates.
   That sampler keeps the first emissions in pool order, so on a map over
   its budget it would see only the oldest blocks; there, with a hint, the
   model is sampled from all the blocks within ``tsdf.streaming.model_reach``
   of the hint (``marching_cubes.extract_sampled_surface_model``). The
   reference drops the overflow flag and keeps the oldest blocks;
2. FPFH on both clouds, voxel-downsampled at one fitted voxel (PCA normals;
   the model's orient toward the hint position);
3. multi-restart RANSAC (``tracking.ransac.global_registration``, at least
   8,192 hypotheses), each restart ranked and gated by the cloud overlap of
   ``evaluate_registration``; then the consensus gate: the winner's RANSAC
   inliers number at least ``MIN_CONSENSUS``, and its rival (the
   best-supported hypothesis among the correspondences the winner leaves
   out) has fewer than ``AMBIGUITY_MAX_RIVAL`` times as many. The overlap
   alone passes a winner with no consensus (a plane lies on a plane
   wherever it is), and ICP then pulls it to whatever repeat of the scene
   is nearest; a rival as well supported as the winner is such a repeat;
4. projective point-to-plane ICP of the whole model sample onto the frame's
   organized maps, gated on the inlier count (most of a grown map projects
   outside one frame, so a ratio over the whole sample would reject correct
   recoveries) and then on rung 0's overlap gate. The reference gates
   on the inlier count alone, which a RANSAC winner outside ICP's basin
   passes: it refines to a wrong pose with thousands of inliers that
   leaves much of the visible model unmatched.

The slide gate (rung 0 and step 4): a plane slid along itself covers the
same pixels, so neither the inlier count nor the overlap gate can see the
slide, and a hint a few frames stale let rung 0 slide along a wall. The
model is sampled with its fused colors, and a candidate pose must pass two
checks. Texture: the matched model points' intensities correlate with the
frame's at the pixels they project to (``icp.photometric_agreement``, zero
mean and normalized, so an exposure change does not matter) by at least
``TEXTURE_GATE_ZNCC``; where the matched model has no texture (intensity
spread under ``TEXTURE_MIN_SPREAD``) the texture cannot contradict the
pose. Relief: at most ``RELIEF_MAX_SHARE`` of the model points that land
on the frame's surface lie in front of it, in space the camera sees as
empty (``icp.free_space_shares_of_points``, the two-camera calibration's
band): relief moved along a wall by a repeat of its texture.
When rung 0's geometric pose fails the slide gate, colored ICP from the
hint (``icp.colored_icp``) refines the slide the geometry cannot hold, and
its pose is gated again. The reference gates on depth alone.

Where a scene repeats along a wall, the texture and the relief repeat too,
and rung 0 from a hint the camera has left behind locks onto the repeat
nearest to it; so the caller asks for rung 0 only while its hint is fresh
(``hint_rung``).

The model samples and descriptors are cached across an episode's retries
(fusion is paused while lost, so the volume does not change). The port's
pools are updated in place, so neither a pool tensor's identity nor its
version counter says whether the volume changed; the cache is keyed on the
pool's address, its content stamp (``tsdf.volume.content_checksums``: one
transfer per attempt) and the hint position. RANSAC draws from a
``torch.Generator`` seeded with ``seed``. Pose math on the host is float64.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig
from azurekinect3dreconstruction_tpu_torch.core import se3
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device, upload
from azurekinect3dreconstruction_tpu_torch.ops.backproject import backproject_depth
from azurekinect3dreconstruction_tpu_torch.ops.image import rgb_to_intensity
from azurekinect3dreconstruction_tpu_torch.ops.neighbors import (
    count_occupied_cells,
    estimate_normals_knn,
    voxel_downsample_arrays,
)
from azurekinect3dreconstruction_tpu_torch.tracking.features import compute_fpfh
from azurekinect3dreconstruction_tpu_torch.tracking.icp import (
    FREE_SPACE_BAND_SIGMAS,
    TargetMaps,
    colored_icp,
    evaluate_registration,
    free_space_shares_of_points,
    icp_projective,
    photometric_agreement,
    projective_overlap,
    relative_depth_noise,
)
from azurekinect3dreconstruction_tpu_torch.tracking.ransac import global_registration
from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import model_reach


# the slide gate's bounds, set on bench.py's corridor (tools/torch_slide_gate_curve.py):
# the texture correlation the truth reaches (a slide of 1-2 cm along the checkered wall
# falls below it), the matched model's intensity spread under which the texture says
# nothing, and the share of the model in the frame's free space (the truth's stays
# under half of it, the wall's repeats 0.2 m off put twice it there)
TEXTURE_GATE_ZNCC = 0.9
TEXTURE_MIN_SPREAD = 0.02
RELIEF_MAX_SHARE = 0.05
# the consensus gate's bounds (tools/torch_reloc_ambiguity.py): the global winner's
# RANSAC inliers (the orbit's recoveries hold 29 to 32 at quarter resolution and 38 to 47
# at 640x576, the corridor's winners 0 to 8 and 0 to 6), and its rival's share of them
# (the orbit's up to 0.44; a repeat as well supported as the winner comes near 1)
MIN_CONSENSUS = 12
AMBIGUITY_MAX_RIVAL = 0.75


class Relocalizer:
    """Recover a world pose for one RGB-D frame from the fused model.

    ``device`` is where the attempts run (default ``"cuda"``; without a card
    raises). The feature constants are the recorder ladder's: a 1.5 cm
    start voxel, normals at 2x and FPFH at 4x the fitted voxel. The pixel
    ``stride`` bounds the frame cloud at about 32k points (4 at 640x576).
    ``n_attempts``, ``n_success`` and ``n_hint_success`` count attempts and
    recoveries (the last by rung 0), ``n_texture_rejects`` and
    ``n_free_space_rejects`` the candidate poses the slide gate turned down
    by texture and by relief (rung 0's included, after which the attempt
    goes on), ``n_consensus_rejects`` the global winners the consensus gate
    turned down; ``last_consensus`` holds the last global winner's (RANSAC
    inliers, rival inliers) and ``last_reject`` says why the last attempt
    failed."""

    def __init__(self, intr: Intrinsics, cfg: Optional[PipelineConfig] = None, *, device="cuda",
                 rays=None, model_points: int = 32768, feature_points: int = 8192,
                 downsample_voxel: float = 0.015, min_inliers: int = 2000,
                 min_depth_pixels: int = 2000, restarts: int = 4, stride: Optional[int] = None,
                 hint_gate_fitness: float = 0.8, seed: int = 0):
        self.device = resolve_device(device)
        self.intr = intr
        self.cfg = cfg or PipelineConfig()
        self.rays = pixel_rays(intr, self.device) if rays is None else rays
        self.model_points = model_points
        self.feature_points = feature_points
        self.downsample_voxel = downsample_voxel
        self.min_inliers = min_inliers
        self.min_depth_pixels = min_depth_pixels
        self.restarts = restarts
        self.hint_gate_fitness = hint_gate_fitness
        # ceil: the ~32k-point bound is the contract (round() would give 3,
        # 41k points, at 640x576)
        self.stride = stride or max(1, int(np.ceil(np.sqrt(intr.height * intr.width / 32768.0))))
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.n_attempts = 0
        self.n_success = 0
        self.n_hint_success = 0
        self.n_texture_rejects = 0
        self.n_free_space_rejects = 0
        self.n_consensus_rejects = 0
        self.last_consensus = (0, 0)  # the global winner's (inliers, rival inliers)
        self.last_reject = ""
        # (key, model points, mask, model intensities, fitted voxel,
        #  {voxel: [points, mask, FPFH or None]})
        self._model_cache = None

    def warmup(self, vol=None) -> float:
        """Run the whole attempt path once and return the seconds it took.

        A process's first attempt otherwise pays one-time set-up inside the
        first loss episode: loading the kernels' library and building it if
        needed (the scratch volume's integrate launches B1), initializing the
        CUDA libraries the ladder calls (the batched SVD and solves), and the
        allocator's first blocks. Nothing is compiled here: PyTorch runs
        eagerly. Two dummy attempts on a gently curved, gray plane, one with
        a hint (rung 0, which accepts) and one without (the descriptor
        ladder), against ``vol`` or a scratch single-frame volume. The
        counters, ``last_reject``, the model cache and the generator's state
        are restored, so the warmup is invisible to the episode logic and to
        the draws of later attempts."""
        t0 = time.perf_counter()
        h, w = self.rays.shape[:2]
        u = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
        v = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
        depth = (1.0 + 0.25 * u + 0.15 * v
                 + 0.05 * np.sin(6.0 * np.pi * u) * np.cos(4.0 * np.pi * v)).astype(np.float32)
        depth = torch.from_numpy(depth).to(self.device)
        color = torch.full((h, w, 3), 0.5, dtype=torch.float32, device=self.device)
        if vol is None:
            vol = tsdf.integrate_frame(
                tsdf.create(self.cfg.tsdf, self.device), depth, color, self.rays,
                torch.eye(4, dtype=torch.float32, device=self.device), self.intr, self.cfg.tsdf)
        state = (self.generator.get_state(), self.n_attempts, self.n_success,
                 self.n_hint_success, self.n_texture_rejects, self.n_free_space_rejects,
                 self.n_consensus_rejects, self.last_consensus, self.last_reject,
                 self._model_cache)
        try:
            self.attempt(vol, depth, color, T_hint=np.eye(4))
            self.attempt(vol, depth, color, T_hint=None)
        finally:
            (gen_state, self.n_attempts, self.n_success, self.n_hint_success,
             self.n_texture_rejects, self.n_free_space_rejects, self.n_consensus_rejects,
             self.last_consensus, self.last_reject, self._model_cache) = state
            self.generator.set_state(gen_state)
        return time.perf_counter() - t0

    def _fit_voxel(self, pts, mask) -> float:
        """The smallest ladder voxel (x1.5 steps from ``downsample_voxel``,
        at most 6) at which the cloud's occupied cells fit 3/4 of the
        feature budget. A saturated downsample drops overflow cells, and
        the dropped sets differ between the two clouds, which kills FPFH
        matching; the discrete rungs keep the model's downsample cacheable."""
        vox = self.downsample_voxel
        budget = int(0.75 * self.feature_points)
        for _ in range(6):
            if int(count_occupied_cells(pts, mask, vox)) <= budget:
                break
            vox *= 1.5
        return vox

    def _overlap_gate(self, mpts, mmask, maps, T_mc):
        """The strict gate: (passed, matched, visible) of the model points
        against the dense frame maps, passed when at least
        ``hint_gate_fitness`` of the visible ones match; a wrong-basin slide
        leaves the misaligned relief uncovered."""
        n_m, n_vis, _ = projective_overlap(mpts, mmask, maps, self.intr, T_mc,
                                           dist_thr=self.cfg.registration.icp_distance_threshold)
        n_m, n_vis = torch.stack([n_m, n_vis]).tolist()
        return n_vis >= self.min_inliers and n_m / n_vis >= self.hint_gate_fitness, n_m, n_vis

    def _slide_gate(self, mpts, mint, mmask, maps, depth, band, T_mc):
        """The slide gate under ``T_mc``: (passed, reason). Texture: the
        matched model intensities' correlation with the frame's
        (:func:`tracking.icp.photometric_agreement`) reaches
        ``TEXTURE_GATE_ZNCC``, or the matched model has no texture. Relief:
        at most ``RELIEF_MAX_SHARE`` of the model points on the frame's
        surface lie in front of it beyond the band. One transfer."""
        corr, spread = photometric_agreement(
            mpts, mint, mmask, maps, self.intr, T_mc,
            dist_thr=self.cfg.registration.icp_distance_threshold)
        in_front, _ = free_space_shares_of_points(mpts, mmask, depth, self.intr, T_mc, band)
        corr, spread, in_front = torch.stack([corr, spread, in_front]).tolist()
        if corr < TEXTURE_GATE_ZNCC and spread >= TEXTURE_MIN_SPREAD:
            self.n_texture_rejects += 1
            return False, f"texture {corr:.3f}"
        if in_front > RELIEF_MAX_SHARE:
            self.n_free_space_rejects += 1
            return False, f"free space {in_front:.4f}"
        return True, ""

    def _enrich(self, ds, dm, orient_to, vox):
        """PCA normals, then FPFH, on a downsampled cloud: the same radii
        for the frame and the model, so both see the same binning."""
        n = estimate_normals_knn(ds, dm, radius=2 * vox, k=12, orient_to=orient_to)
        return compute_fpfh(ds, n, dm, radius=4 * vox, k=16)

    def attempt(self, vol, depth, color, T_hint=None, hint_rung: bool = True
                ) -> Optional[np.ndarray]:
        """Try to relocalize one frame against the fused volume.

        ``depth``: (H, W) meters (0 = invalid); ``color``: the frame's (H,
        W, 3) RGB, float in [0, 1] or uint8, registered to the depth, which
        the slide gate reads; each a tensor or a host array. ``T_hint``:
        the last-known camera-to-world pose; it seeds rung 0 (unless
        ``hint_rung`` is False: a stale hint), orients the model's normals
        and places a view-local model sample. Returns the recovered
        camera-to-world pose (host float64 4x4) or None, with
        ``last_reject`` saying why."""
        reg = self.cfg.registration
        dev = self.device
        self.n_attempts += 1
        depth = upload(depth, dev).to(torch.float32)
        color = upload(color, dev)
        if tuple(color.shape) != (*depth.shape, 3):
            raise ValueError(f"color must be (H, W, 3) registered to the depth {tuple(depth.shape)}"
                             f", got {tuple(color.shape)}")
        color = color.to(torch.float32) * (1.0 / 255.0 if color.dtype == torch.uint8 else 1.0)
        # an occluded or empty frame, the usual cause of the loss, cannot
        # register: skip the ladder
        if int((depth > 0).sum()) < self.min_depth_pixels:
            self.last_reject = "empty_frame"
            return None

        cam_pos = np.zeros(3) if T_hint is None else np.asarray(T_hint, np.float64)[:3, 3]
        key = (vol.tsdf.data_ptr(), tsdf.content_checksums(vol).cpu().numpy().tobytes(),
               cam_pos.tobytes())
        if self._model_cache is None or self._model_cache[0] != key:
            mpts, mmask, ovf, mcol = mc.extract_surface_samples(
                vol, self.cfg.tsdf, self.model_points, return_colors=True)
            if T_hint is not None and bool(ovf):
                # the sampler keeps the first emissions in pool order, the
                # oldest part of the map: sample the blocks near the hint,
                # every one of them (a stride over blocks leaves holes that
                # let the hint rung slide), their triangles strided to the budget
                mpts, mmask, _, mcol = mc.extract_sampled_surface_model(
                    vol, self.cfg.tsdf, self.model_points,
                    torch.as_tensor(T_hint, dtype=torch.float32).to(dev), model_reach(self.cfg),
                    sample_blocks=int(vol.n_blocks), return_colors=True)
            self._model_cache = (key, mpts, mmask, rgb_to_intensity(mcol),
                                 self._fit_voxel(mpts, mmask), {})
        _, mpts, mmask, mint, m_vox, m_feats = self._model_cache

        src = backproject_depth(depth, self.rays)[::self.stride, ::self.stride].reshape(-1, 3)
        s_mask = src[:, 2] > 0
        # one voxel for both clouds, fitted so that neither saturates its grid
        vox = max(m_vox, self._fit_voxel(src, s_mask))
        if vox not in m_feats:
            m_ds, m_dm, _, _ = voxel_downsample_arrays(mpts, mmask, vox, self.feature_points)
            m_feats[vox] = [m_ds, m_dm, None]
        m_ds, m_dm, _ = m_feats[vox]
        s_ds, s_dm, _, _ = voxel_downsample_arrays(src, s_mask, vox, self.feature_points)
        # the intensity and its gradients serve the slide gate and colored ICP
        maps = TargetMaps.from_depth(depth, self.rays, intensity=rgb_to_intensity(color))
        band = FREE_SPACE_BAND_SIGMAS * relative_depth_noise(depth)
        slide = lambda T: self._slide_gate(mpts, mint, mmask, maps, depth, band, T)
        f32 = lambda T: torch.as_tensor(T, dtype=torch.float32).to(dev)

        # rung 0: hint-seeded model ICP, 3x the threshold then 1x; a pose
        # that slid along a surface is refined from the hint by colored ICP
        if (hint_rung and T_hint is not None
                and se3.is_valid_transform(np.asarray(T_hint, np.float64))):
            init = f32(np.linalg.inv(np.asarray(T_hint, np.float64)))
            r0 = icp_projective(mpts, mmask, maps, self.intr, init=init, max_iters=25,
                                dist_thr=3 * reg.icp_distance_threshold)
            r1 = icp_projective(mpts, mmask, maps, self.intr, init=r0.T, max_iters=15,
                                dist_thr=reg.icp_distance_threshold)
            held = lambda r: (int(r.inliers) >= self.min_inliers
                              and se3.is_valid_transform(r.T.cpu().numpy().astype(np.float64))
                              and self._overlap_gate(mpts, mmask, maps, r.T)[0])
            ok = held(r1)
            if ok and not slide(r1.T)[0]:
                r1 = colored_icp(mpts, mint, mmask, maps, self.intr, init=init, cfg=reg)
                ok = held(r1) and slide(r1.T)[0]
            if ok:
                self.n_success += 1
                self.n_hint_success += 1
                self.last_reject = ""
                return np.linalg.inv(r1.T.cpu().numpy().astype(np.float64))

        # the global ladder; the model's descriptors are memoized per voxel
        if m_feats[vox][2] is None:
            m_feats[vox][2] = self._enrich(m_ds, m_dm, cam_pos, vox)
        m_f = m_feats[vox][2]
        s_f = self._enrich(s_ds, s_dm, np.zeros(3), vox)
        reg_full = dataclasses.replace(reg, ransac_hypotheses=max(8192, reg.ransac_hypotheses))
        eval_thr = max(0.05, 3.0 * vox)
        best, best_fit = None, -1.0
        self.last_consensus = (0, 0)
        for _ in range(self.restarts):
            # the winning hypothesis maps the frame (camera) into the world
            g = global_registration(s_ds, s_f, s_dm, m_ds, m_f, m_dm, reg_full,
                                    distance_threshold=max(0.04, 2.5 * vox),
                                    generator=self.generator)
            T = g.T.cpu().numpy().astype(np.float64)
            if not se3.is_valid_transform(T):
                continue
            fit, _ = evaluate_registration(s_ds, s_dm, m_ds, m_dm, g.T, dist_thr=eval_thr)
            if float(fit) > best_fit:
                best, best_fit = T, float(fit)
                n_f, n_r = torch.stack([torch.round(g.fitness * g.n_correspondences),
                                        g.rival.to(torch.float32)]).tolist()
                self.last_consensus = (int(n_f), int(n_r))
        if best is None or best_fit < reg.min_fitness_global:
            self.last_reject = f"global overlap {best_fit:.3f}"
            return None
        # the winner's consensus: enough correspondences, and no rival pose
        # nearly as well supported (a scene that repeats)
        n_f, n_r = self.last_consensus
        if n_f < MIN_CONSENSUS or n_r >= AMBIGUITY_MAX_RIVAL * n_f:
            self.n_consensus_rejects += 1
            self.last_reject = f"global consensus {n_f}, rival {n_r}"
            return None

        # refine: the whole model sample onto the frame's maps
        res = icp_projective(mpts, mmask, maps, self.intr, init=f32(np.linalg.inv(best)),
                             max_iters=15, dist_thr=reg.icp_distance_threshold)
        T_mc = res.T.cpu().numpy().astype(np.float64)
        if int(res.inliers) < self.min_inliers:
            self.last_reject = f"icp inliers {int(res.inliers)}"
            return None
        if not se3.is_valid_transform(T_mc):
            self.last_reject = "icp transform invalid"
            return None
        ok, n_m, n_vis = self._overlap_gate(mpts, mmask, maps, res.T)
        if not ok:
            self.last_reject = f"icp overlap {n_m}/{n_vis}"
            return None
        ok, why = slide(res.T)
        if not ok:
            self.last_reject = f"icp {why}"
            return None
        self.n_success += 1
        self.last_reject = ""
        return np.linalg.inv(T_mc)
