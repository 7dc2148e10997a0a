"""Point-cloud accumulation without a TSDF (the counterpart of the JAX
package's ``pipelines/cloud_accumulator.py``).

Every ``keyframe_interval``-th frame is registered to the previous keyframe
by projective point-to-plane ICP; where its fitness is low, the FPFH +
RANSAC seeds of 4 restarts are each refined coarse to fine and the best
refinement is kept if it fits better (the reference refines only the
restart of most cloud overlap, once); fresh seeds are drawn, up to 4 rounds
in all, while the result would be rejected, and also while no seed has
beaten the un-seeded result or refined to the same pose (an accepted
un-seeded result can be a wrong minimum that no single losing seed
disproves). The keyframe's points join the host model in
the world frame, and a model over ``model_capacity`` points is voxel
downsampled. The save orients the model's normals toward the nearest
trajectory position, repairs them for consistency, writes the cloud and,
with Poisson, a mesh painted from the cloud.

The reference's downsample can drop cells: it asks for ``model_capacity``
cells at ``cfg.voxel_downsample`` whatever the model covers, and a saturated
grid drops the cells past the capacity, each time a few more, so a long scan
loses the regions it saw first. Here the voxel is fitted first: it grows in
x1.5 steps from ``cfg.voxel_downsample`` until the occupied cells fit, each
step counted in ``telemetry`` as ``model_coarsened``. Where the reference
does not saturate, the result is the same.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig
from azurekinect3dreconstruction_tpu_torch.core import se3
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device, upload
from azurekinect3dreconstruction_tpu_torch.core.types import PointCloudHost, RGBDFrame
from azurekinect3dreconstruction_tpu_torch.meshing.poisson import poisson_mesh_from_cloud
from azurekinect3dreconstruction_tpu_torch.meshing.sampling import transfer_colors
from azurekinect3dreconstruction_tpu_torch.ops.backproject import backproject_depth
from azurekinect3dreconstruction_tpu_torch.ops.neighbors import (
    auto_capacity,
    count_occupied_cells,
    estimate_normals_knn,
    voxel_downsample_arrays,
)
from azurekinect3dreconstruction_tpu_torch.ops.normals import orient_normals_consistent
from azurekinect3dreconstruction_tpu_torch.tracking.features import compute_fpfh
from azurekinect3dreconstruction_tpu_torch.tracking.icp import (
    TargetMaps,
    evaluate_registration,
    icp_point_to_plane,
)
from azurekinect3dreconstruction_tpu_torch.tracking.ransac import global_registration
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import Telemetry, log_warning
from azurekinect3dreconstruction_tpu_torch.viz.savers import ResultSaver

_COARSE_VOXEL = 0.015  # the coarse stage's grid; normals at 2x, FPFH at 4x
_COARSE_ROUNDS = 4  # seeds a coarse stage draws at most, while the result is unconfirmed


class CloudAccumulator:
    """Feed raw (depth_u16, color_u8) frames; ``save_model`` writes the model.

    ``device`` is where registration runs (default ``"cuda"``; without a card
    raises); the model lives on the host. ``coarse`` runs the FPFH + RANSAC
    seed when the un-seeded ICP's fitness is under ``coarse_skip_fitness``
    (0.8; 1.1 runs it at every keyframe); RANSAC draws from ``generator``, a
    ``torch.Generator`` on the device seeded with 3. ``telemetry`` counts
    ``coarse_reject``, ``coarse_won``, ``coarse_retry``, ``reg_fail`` and
    ``model_coarsened``, and times the coarse stage (``coarse``)."""

    def __init__(self, intrinsics: Intrinsics, config: Optional[PipelineConfig] = None, *,
                 device="cuda", model_capacity: int = 262144, output_dir: str = "results",
                 coarse: bool = True):
        self.device = resolve_device(device)
        self.intr = intrinsics
        self.cfg = config or PipelineConfig()
        self.rays = pixel_rays(intrinsics, self.device)
        self.capacity = model_capacity
        self.coarse = coarse
        self.coarse_skip_fitness = 0.8
        self.model_points = np.zeros((0, 3), np.float32)
        self.model_colors = np.zeros((0, 3), np.float32)
        self.T_world_cam = np.eye(4)
        self._cam_centers = [np.zeros(3)]  # the trajectory, for normal orientation
        self.prev_maps: Optional[TargetMaps] = None
        # (ds, dm, normals, FPFH) of the last keyframe's coarse source: the
        # next keyframe's coarse target exactly (prev_maps backprojects the
        # same depth), so it is handed over instead of recomputed
        self._feat_cache = None
        self._feat_next = None
        self.telemetry = Telemetry()
        self.saver = ResultSaver(output_dir)
        self.frame_index = 0
        self.generator = torch.Generator(device=self.device).manual_seed(3)

    def _features(self, pts, mask):
        """(downsampled points, mask, normals, FPFH) of a coarse-stage cloud
        on the 1.5 cm grid; the source and the target go through the same
        steps, which is what makes the feature cache exact."""
        ds, dm, _, _ = voxel_downsample_arrays(pts, mask, _COARSE_VOXEL, 8192)
        n = estimate_normals_knn(ds, dm, radius=2 * _COARSE_VOXEL, k=12, orient_to=np.zeros(3))
        return ds, dm, n, compute_fpfh(ds, n, dm, radius=4 * _COARSE_VOXEL, k=16)

    def _target_features(self):
        """The coarse target's features from ``prev_maps`` at the source's
        1/16 pixel subsample."""
        tgt = self.prev_maps.points[::4, ::4].reshape(-1, 3)
        return self._features(tgt, tgt[:, 2] > 0)

    def _ransac_seeds(self, src_features, tgt_features) -> List[torch.Tensor]:
        """The seeds from two feature tuples of :meth:`_features`: the valid
        transforms of 4 RANSAC restarts of at least 8,192 hypotheses, ranked
        by the cloud overlap of ``evaluate_registration``, most first (the
        reference's seed is the first; RANSAC's own inlier share is gamed by
        smooth surfaces, where most mutual matches are wrong)."""
        reg = dataclasses.replace(self.cfg.registration, ransac_hypotheses=max(
            8192, self.cfg.registration.ransac_hypotheses))
        (ds, dm, _, f_s), (dt, dtm, _, f_t) = src_features, tgt_features
        ranked = []
        for i in range(4):
            g = global_registration(ds, f_s, dm, dt, f_t, dtm, reg, distance_threshold=0.04,
                                    generator=self.generator)
            if not se3.is_valid_transform(g.T.cpu().numpy()):
                continue
            fit, _ = evaluate_registration(ds, dm, dt, dtm, g.T, dist_thr=0.05)
            ranked.append((-float(fit), i, g.T))
        if not ranked:
            self.telemetry.count("coarse_reject")
        return [T for _, _, T in sorted(ranked, key=lambda r: r[:2])]

    def _coarse_register(self, flat, mask, res):
        """The coarse stage of a keyframe whose un-seeded ICP result ``res``
        fits poorly: each FPFH + RANSAC seed of a round refined at 3x the
        correspondence radius (a seed can sit several cm off), then at 1x;
        the refinement that fits best replaces ``res`` where it fits better.
        The reference's whole stage is one round that refines only the seed
        of most overlap. On a hard pair nearly every mutual FPFH match is
        wrong, so a seed lands in ICP's basin only on some draws, and the
        seed of most overlap can be a wrong attractor round after round
        while another restart's seed refines to the truth (on the card 4
        of 20 generator seeds of the large-motion pair at quarter
        resolution ended rejected so, ``tools/torch_coarse_seed_rate.py``).
        So every seed is refined, and
        another round draws fresh seeds, at most ``_COARSE_ROUNDS`` in all,
        while the result would still be rejected (fitness under
        ``min_fitness_icp``) or is not yet confirmed: no seed has won, and
        none refined to within ``icp_distance_threshold`` of the un-seeded
        pose (on the card a wrong un-seeded minimum 0.44 m off passed the
        gate while the one seed drawn lost)."""
        reg = self.cfg.registration
        wide = dataclasses.replace(reg, icp_distance_threshold=3 * reg.icp_distance_threshold)
        self._feat_next = self._features(flat, mask)
        tgt = self._feat_cache if self._feat_cache is not None else self._target_features()
        won = confirmed = False
        for k in range(_COARSE_ROUNDS):
            if k:
                self.telemetry.count("coarse_retry")
            for seed in self._ransac_seeds(self._feat_next, tgt):
                r1 = icp_point_to_plane(flat, mask, self.prev_maps, self.intr, init=seed,
                                        cfg=wide)
                r2 = icp_point_to_plane(flat, mask, self.prev_maps, self.intr, init=r1.T,
                                        cfg=reg)
                if float(r2.fitness) > float(res.fitness):
                    res, won = r2, True
                elif not won:
                    confirmed = confirmed or se3.same_pose(r2.T, res.T, reg.icp_distance_threshold)
            if float(res.fitness) >= reg.min_fitness_icp and (won or confirmed):
                break
        if won:
            self.telemetry.count("coarse_won")
        return res

    def process_frame(self, depth_raw, color_raw) -> None:
        if self.frame_index % self.cfg.keyframe_interval != 0:
            self.frame_index += 1
            return
        cam = self.cfg.camera
        frame = RGBDFrame.from_raw(upload(depth_raw, self.device), upload(color_raw, self.device),
                                   cam.depth_scale, cam.depth_trunc, cam.depth_min)
        flat = backproject_depth(frame.depth, self.rays)[::4, ::4].reshape(-1, 3)
        mask = flat[:, 2] > 0
        if self.prev_maps is not None:
            reg = self.cfg.registration
            res = icp_point_to_plane(flat, mask, self.prev_maps, self.intr, cfg=reg)
            self._feat_next = None
            if self.coarse and float(res.fitness) < self.coarse_skip_fitness:
                with self.telemetry.time_block("coarse"):
                    res = self._coarse_register(flat, mask, res)
            if float(res.fitness) >= reg.min_fitness_icp:
                # res.T maps this frame's points into the previous keyframe's
                # frame: T_w_curr = T_w_prev @ T_prev_curr
                self.T_world_cam = self.T_world_cam @ res.T.cpu().numpy().astype(np.float64)
            else:
                log_warning("frame registration rejected; pose kept")
                self.telemetry.count("reg_fail")
        self.prev_maps = TargetMaps.from_depth(frame.depth, self.rays)
        # set only where the coarse stage ran this keyframe; else the next
        # coarse call rebuilds the target features from prev_maps
        self._feat_cache, self._feat_next = self._feat_next, None
        T = torch.as_tensor(self.T_world_cam, dtype=torch.float32).to(self.device)
        m = mask.cpu().numpy()
        self._cam_centers.append(self.T_world_cam[:3, 3].copy())
        self.model_points = np.concatenate(
            [self.model_points, se3.transform_points(T, flat).cpu().numpy()[m]])
        self.model_colors = np.concatenate(
            [self.model_colors, frame.color[::4, ::4].reshape(-1, 3).cpu().numpy()[m]])
        if self.model_points.shape[0] > self.capacity:
            self._redownsample()
        self.frame_index += 1
        self.telemetry.tick_frame()
        self.telemetry.maybe_report(extra=f"model {len(self.model_points)} pts")

    def _redownsample(self) -> None:
        """Voxel-downsample the model into at most ``capacity`` cells, at
        the first voxel of the x1.5 ladder from ``cfg.voxel_downsample``
        whose occupied cells fit (each step counted as ``model_coarsened``),
        so that no cell is dropped."""
        pts = torch.from_numpy(self.model_points).to(self.device)
        mask = torch.ones((pts.shape[0],), dtype=torch.bool, device=self.device)
        vox = self.cfg.voxel_downsample
        while int(count_occupied_cells(pts, mask, vox)) > self.capacity:
            vox *= 1.5
            self.telemetry.count("model_coarsened")
        dp, dm, dc, _ = voxel_downsample_arrays(
            pts, mask, vox, self.capacity,
            colors=torch.from_numpy(self.model_colors).to(self.device))
        m = dm.cpu().numpy()
        self.model_points = dp.cpu().numpy()[m]
        self.model_colors = dc.cpu().numpy()[m]

    def model_cloud(self) -> PointCloudHost:
        """The model with normals (None while it is empty): PCA normals
        flipped toward the nearest trajectory position (a multi-view model
        has no single center to face), then made consistent between
        neighbors."""
        n = self.model_points.shape[0]
        if not n:
            return PointCloudHost(points=self.model_points, colors=self.model_colors)
        pts = torch.from_numpy(self.model_points).to(self.device)
        mask = torch.ones((n,), dtype=torch.bool, device=self.device)
        radius = 3 * self.cfg.voxel_downsample
        nr = estimate_normals_knn(pts, mask, radius=radius, k=16,
                                  capacity=auto_capacity(n)).cpu().numpy()
        centers = np.asarray(self._cam_centers, np.float32)
        if len(centers) > 256:  # bound the (P, C) distance matrix
            centers = centers[:: len(centers) // 256 + 1]
        # |p - c|^2 up to the per-point constant, as a matrix product
        d2 = (centers ** 2).sum(1)[None, :] - 2.0 * self.model_points @ centers.T
        nearest = centers[np.argmin(d2, axis=1)]
        flip = np.einsum("ij,ij->i", nr, nearest - self.model_points) < 0
        nr = np.where(flip[:, None], -nr, nr).astype(np.float32)
        nr = orient_normals_consistent(pts, torch.from_numpy(nr).to(self.device), mask,
                                       radius=radius)
        return PointCloudHost(points=self.model_points, colors=self.model_colors,
                              normals=nr.cpu().numpy())

    def save_model(self, poisson: bool = False) -> dict:
        """The model cloud with normals as PLY and, with ``poisson`` (and
        Open3D installed), a Poisson mesh painted from the cloud. Returns
        {"pointcloud"[, "mesh"]} paths."""
        cloud = self.model_cloud()
        paths = {"pointcloud": self.saver.save_point_cloud(cloud, kind="model")}
        if poisson:
            mesh = poisson_mesh_from_cloud(cloud)
            if mesh is not None:
                if mesh.vertex_colors is None:
                    mesh = transfer_colors(mesh, cloud, radius=self.cfg.voxel_downsample,
                                           device=self.device)
                paths["mesh"] = self.saver.save_mesh(mesh, kind="poisson_mesh")
        return paths
