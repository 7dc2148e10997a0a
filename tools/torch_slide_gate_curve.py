"""What the relocalizer's slide gate reads at the truth and at poses slid
along bench.py's corridor wall.

    python tools/torch_slide_gate_curve.py [--device cpu|cuda] [--scale S]

The corridor (``cli.bench.corridor_scene``: a checkered wall 0.55 m ahead,
10 cm squares, and 33 spheres 0.3 m apart) is fused at its true poses, 8 cm
apart from x = 0 to 1.92 m, into 2 cm voxels (``depth_trunc`` 0.7 m, quarter
resolution unless ``--scale``). For the frames at x = 0.48, 0.96 and 1.44 m,
the relocalizer's model (its colored sample, hinted at the truth) is held
against the frame at the true pose moved by ``dx`` along the wall (x, and
the diagonal of the checker), and one JSON line a pose gives what the gate
and the overlap gate read there: the texture correlation
(``icp.photometric_agreement``), the matched model's intensity spread, the
share of the model in the frame's free space, and matched over visible
model points. The wall repeats every 0.2 m along x and y and every 0.14 m
along its diagonal, and the spheres every 0.6 m, so some slides match the
truth's texture and only the relief tells them apart. Runs on the card
unless ``--device cpu``; needs no jax.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from azurekinect3dreconstruction_tpu_torch.cli.bench import corridor_scene  # noqa: E402
from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig, TSDFConfig  # noqa: E402
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays  # noqa: E402
from azurekinect3dreconstruction_tpu_torch.core.types import RGBDFrame  # noqa: E402
from azurekinect3dreconstruction_tpu_torch.io.synthetic import SyntheticCamera  # noqa: E402
from azurekinect3dreconstruction_tpu_torch.ops.image import rgb_to_intensity  # noqa: E402
from azurekinect3dreconstruction_tpu_torch.tracking import icp  # noqa: E402
from azurekinect3dreconstruction_tpu_torch.tracking.relocalize import Relocalizer  # noqa: E402
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf  # noqa: E402

SLIDES = ((0.0, 0.0), (0.01, 0.0), (0.02, 0.0), (0.05, 0.0), (0.1, 0.0), (0.14, 0.0),
          (0.2, 0.0), (0.1, 0.1), (0.4, 0.0), (0.6, 0.0), (-0.2, 0.0), (-0.6, 0.0))


def _pose(x, y=0.0):
    T = np.eye(4)
    T[0, 3], T[1, 3] = x, y
    return T


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=0.25)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(4)
    cfg = PipelineConfig(tsdf=TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8,
                                         block_capacity=2048, hash_capacity=8192))
    cfg = dataclasses.replace(cfg, camera=cfg.camera.replace(depth_trunc=0.7))
    intr = Intrinsics.azure_kinect_depth_nfov().scaled(args.scale)
    cam = SyntheticCamera(scene=corridor_scene(), intrinsics=intr, device=dev)
    rays = pixel_rays(intr, dev)
    cc = cfg.camera

    def frame(x):
        d, c = cam.capture(_pose(x))
        return RGBDFrame.from_raw(torch.from_numpy(d).to(dev), torch.from_numpy(c).to(dev),
                                  cc.depth_scale, cc.depth_trunc, cc.depth_min)

    vol = tsdf.create(cfg.tsdf, dev)
    for i in range(25):
        f = frame(0.08 * i)
        vol = tsdf.integrate_frame(vol, f.depth, f.color, rays,
                                   torch.as_tensor(_pose(0.08 * i), dtype=torch.float32,
                                                   device=dev), intr, cfg.tsdf)
    thr = cfg.registration.icp_distance_threshold
    for x in (0.48, 0.96, 1.44):
        f = frame(x)
        reloc = Relocalizer(intr, cfg, device=dev, rays=rays, min_inliers=500, restarts=1)
        reloc.attempt(vol, f.depth, f.color, T_hint=_pose(x))
        _, mpts, mmask, mint, _, _ = reloc._model_cache
        maps = icp.TargetMaps.from_depth(f.depth, rays, intensity=rgb_to_intensity(f.color))
        band = icp.FREE_SPACE_BAND_SIGMAS * icp.relative_depth_noise(f.depth)
        for dx, dy in SLIDES:
            T = torch.as_tensor(np.linalg.inv(_pose(x + dx, dy)), dtype=torch.float32,
                                device=dev)
            corr, spread = icp.photometric_agreement(mpts, mint, mmask, maps, intr, T,
                                                     dist_thr=thr)
            in_front, _ = icp.free_space_shares_of_points(mpts, mmask, f.depth, intr, T, band)
            n_m, n_vis, _ = icp.projective_overlap(mpts, mmask, maps, intr, T, dist_thr=thr)
            print(json.dumps({"x": x, "slide_m": [dx, dy], "texture": round(float(corr), 4),
                              "spread": round(float(spread), 4),
                              "free_space": round(float(in_front), 4),
                              "overlap": round(int(n_m) / max(int(n_vis), 1), 4),
                              "device": args.device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
