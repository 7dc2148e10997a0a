"""Staged fragment pipeline: capture -> make fragments -> register -> refine
-> integrate (the counterpart of the JAX package's ``pipelines/fragments.py``).

``make_fragments`` builds a downsampled, outlier-filtered cloud with normals
for each captured frame and, with ``mesh_fragments``, a surface mesh from a
single-frame TSDF (kernel B1) and marching cubes, sampled uniformly;
``register_fragments`` aligns each fragment to fragment 0 by point-to-point
ICP on the mesh samples, then point-to-plane ICP with a tighter threshold;
``integrate_scene`` fuses every frame into one TSDF at its estimated pose
(kernel B1) and extracts the mesh. So B1 launches twice per captured frame
when the fragments are meshed, and B2 never.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device, upload
from azurekinect3dreconstruction_tpu_torch.core.types import RGBDFrame, TriangleMeshHost
from azurekinect3dreconstruction_tpu_torch.meshing.sampling import sample_points_uniformly
from azurekinect3dreconstruction_tpu_torch.ops.backproject import backproject_depth
from azurekinect3dreconstruction_tpu_torch.ops.neighbors import (
    estimate_normals_knn,
    remove_statistical_outliers,
    voxel_downsample_arrays,
)
from azurekinect3dreconstruction_tpu_torch.tracking.icp import icp_grid, icp_point_to_point
from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info, log_warning


class Fragment:
    """One captured frame's fragment: its downsampled cloud (points, mask,
    normals on the device), its pose ``T_world_fragment`` (host float64) and,
    when meshed, its uniform mesh-surface samples and their normals."""

    def __init__(self, frame: RGBDFrame, points, mask, normals):
        self.frame = frame
        self.points = points
        self.mask = mask
        self.normals = normals
        self.pose = np.eye(4)
        self.samples = None
        self.sample_normals = None


class FragmentPipeline:
    """Capture raw (depth_u16, color_u8) frames, then ``run()`` the stages.

    ``device`` is ``"cuda"``, the default (kernel B1 on the card) or ``"cpu"``
    (its plain version); ``"cuda"`` without a card raises. ``downsample`` is
    the fragment clouds' voxel (at most ``capacity`` cells); a fragment's mesh
    comes from a single-frame volume at the larger of the TSDF voxel and half
    the downsample voxel, freed before the next fragment is meshed."""

    def __init__(self, intrinsics: Intrinsics, config: Optional[PipelineConfig] = None, *,
                 device="cuda", downsample: float = 0.02, capacity: int = 16384,
                 mesh_fragments: bool = True, sample_points: int = 100_000):
        self.device = resolve_device(device)
        self.intr = intrinsics
        self.cfg = config or PipelineConfig()
        self.rays = pixel_rays(intrinsics, self.device)
        self.downsample = downsample
        self.capacity = capacity
        self.mesh_fragments = mesh_fragments
        self.sample_points = sample_points
        self.captured: List[RGBDFrame] = []
        self.fragments: List[Fragment] = []
        self.volume = None

    # stage 0: manual capture
    def capture(self, depth_raw, color_raw) -> int:
        cam = self.cfg.camera
        self.captured.append(RGBDFrame.from_raw(
            upload(depth_raw, self.device), upload(color_raw, self.device), cam.depth_scale,
            cam.depth_trunc, cam.depth_min))
        log_info(f"captured frame {len(self.captured)}")
        return len(self.captured)

    # stage 1: make fragments
    def make_fragments(self) -> int:
        self.fragments = []
        for f in self.captured:
            pts = backproject_depth(f.depth, self.rays)[::2, ::2].reshape(-1, 3)
            dp, dm, _, _ = voxel_downsample_arrays(pts, pts[:, 2] > 0, self.downsample,
                                                   self.capacity)
            dm = remove_statistical_outliers(dp, dm, k=12, radius=3 * self.downsample)
            nrm = estimate_normals_knn(dp, dm, radius=3 * self.downsample, k=12,
                                       orient_to=np.zeros(3))
            frag = Fragment(f, dp, dm, nrm)
            if self.mesh_fragments:
                self._mesh_fragment(frag)
            self.fragments.append(frag)
        log_info(f"made {len(self.fragments)} fragments")
        return len(self.fragments)

    def _fragment_mesh(self, frame: RGBDFrame) -> TriangleMeshHost:
        """One frame's surface from a single-frame TSDF (B1) and marching
        cubes, welded, with vertex normals. The volume is a whole pool and
        is released on return, before the next fragment's."""
        fcfg = dataclasses.replace(
            self.cfg.tsdf, voxel_size=max(self.cfg.tsdf.voxel_size, self.downsample / 2),
            sdf_trunc=max(self.cfg.tsdf.sdf_trunc, self.downsample))
        vol = tsdf.integrate_frame(tsdf.create(fcfg, self.device), frame.depth, frame.color,
                                   self.rays, torch.eye(4, dtype=torch.float32, device=self.device),
                                   self.intr, fcfg)
        return mc.weld_vertices(mc.extract_mesh(vol, fcfg).compact()).compute_vertex_normals()

    def _mesh_fragment(self, frag: Fragment) -> None:
        """``sample_points`` uniform samples, with normals, of the fragment's
        surface mesh."""
        cloud = sample_points_uniformly(self._fragment_mesh(frag.frame), self.sample_points,
                                        seed=0)
        frag.samples = torch.from_numpy(cloud.points).to(self.device)
        frag.sample_normals = torch.from_numpy(cloud.normals).to(self.device)

    # stages 2 and 3: register, then refine, against fragment 0
    def register_fragments(self, coarse_dist: float = 0.08,
                           fine_dist: float = 0.02) -> List[np.ndarray]:
        if not self.fragments:
            self.make_fragments()
        base = self.fragments[0]
        ones = lambda t: torch.ones((t.shape[0],), dtype=torch.bool, device=self.device)
        for i, frag in enumerate(self.fragments[1:], start=1):
            if self.mesh_fragments and frag.samples is not None:
                # point-to-point on the mesh samples; cells of half the
                # threshold with 16 slots keep the dense target whole (cells
                # of the threshold would thin it to 8 points per 8 cm cell)
                coarse = icp_point_to_point(frag.samples, ones(frag.samples), base.samples,
                                            ones(base.samples), max_iters=30,
                                            dist_thr=coarse_dist, cell_size=coarse_dist / 2,
                                            max_per_cell=16, capacity=65536)
                fine = icp_grid(frag.samples, ones(frag.samples), base.samples,
                                base.sample_normals, ones(base.samples), init=coarse.T,
                                max_iters=30, dist_thr=fine_dist)
            else:
                coarse = icp_grid(frag.points, frag.mask, base.points, base.normals, base.mask,
                                  max_iters=30, dist_thr=coarse_dist)
                fine = icp_grid(frag.points, frag.mask, base.points, base.normals, base.mask,
                                init=coarse.T, max_iters=30, dist_thr=fine_dist)
            fit, rmse = torch.stack([fine.fitness.to(torch.float32), fine.inlier_rmse]).tolist()
            if fit < 0.3:
                log_warning(f"fragment {i}: low fitness {fit:.2f}")
            frag.pose = fine.T.cpu().numpy().astype(np.float64)
            log_info(f"fragment {i}: fitness {fit:.2f} rmse {rmse * 1000:.1f}mm")
        return [f.pose for f in self.fragments]

    # stage 4: integrate the scene
    def integrate_scene(self) -> TriangleMeshHost:
        """Every frame into one TSDF at its fragment pose (B1 once a frame);
        the welded mesh with vertex normals. The volume stays in
        ``self.volume``."""
        vol = tsdf.create(self.cfg.tsdf, self.device)
        for frag in self.fragments:
            vol = tsdf.integrate_frame(
                vol, frag.frame.depth, frag.frame.color, self.rays,
                torch.as_tensor(frag.pose, dtype=torch.float32).to(self.device), self.intr,
                self.cfg.tsdf)
        self.volume = vol
        mesh = mc.weld_vertices(mc.extract_mesh(vol, self.cfg.tsdf).compact())
        mesh.compute_vertex_normals()
        return mesh

    def run(self) -> TriangleMeshHost:
        """All stages on whatever was captured."""
        self.make_fragments()
        self.register_fragments()
        return self.integrate_scene()
