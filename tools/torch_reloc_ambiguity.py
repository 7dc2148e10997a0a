"""What the relocalizer's global ladder finds, and its consensus gate reads,
on bench.py's corridor, where the scene repeats, and on the orbit scene,
where it does not.

    python tools/torch_reloc_ambiguity.py [--device cpu|cuda] [--scale S] [--seeds N]

Corridor (``cli.bench.corridor_scene``: a checkered wall 0.55 m ahead, 10
cm squares, 33 spheres 0.3 m apart, alternating sides and colors, so the
scene repeats every 0.6 m): ``chip_smoke.py``'s streaming run at full
resolution, 120 frames 4.5 cm apart fused at their true poses into 5 mm
voxels, then frames on the way back from the loss run's dark site (x =
3.375 m) at 2 to 40 frames past it, each attempted with the dark site as
a stale hint (``hint_rung=False``: the global ladder alone). Orbit (the
default synthetic scene): 8 poses with pose 4 held out, fused at 1 cm;
pose 4 attempted with a hint 1.3 m off. Each attempt runs twice from the
same generator seed: with the gate, and with ``MIN_CONSENSUS`` 0 and
``AMBIGUITY_MAX_RIVAL`` infinite, which says where the ladder would have
put the camera. One JSON line an attempt: the winner's RANSAC inliers and
its rival's, the gated result, and the ungated pose's error from the
truth. Runs on the card unless ``--device cpu``; needs no jax.
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
from azurekinect3dreconstruction_tpu_torch.core import se3  # noqa: E402
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays  # noqa: E402
from azurekinect3dreconstruction_tpu_torch.core.types import RGBDFrame  # noqa: E402
from azurekinect3dreconstruction_tpu_torch.io.synthetic import (  # noqa: E402
    SyntheticCamera,
    orbit_trajectory,
)
from azurekinect3dreconstruction_tpu_torch.tracking import relocalize  # noqa: E402
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf  # noqa: E402

CORRIDOR_OUT, CORRIDOR_STEP, DARK_X = 120, 0.045, 3.375
CORRIDOR_LATE = (2, 6, 10, 14, 18, 22, 26, 30, 34, 38)  # frames past the dark site


def _pose_err(T, T_true):
    xi = se3.se3_log(torch.as_tensor(np.linalg.inv(T_true) @ T, dtype=torch.float64)).numpy()
    return float(np.linalg.norm(xi[:3])), float(np.linalg.norm(xi[3:]))


def _x(x):
    T = np.eye(4)
    T[0, 3] = x
    return T


def _attempts(scene, reloc, vol, depth, color, hint, truth, seeds, extra):
    """Each seed's attempt with the gate and without; one JSON line each."""
    for s in range(seeds):
        out = dict(extra, scene=scene, seed=s)
        for gated in (True, False):
            reloc.generator.manual_seed(s)
            if not gated:
                relocalize.MIN_CONSENSUS, relocalize.AMBIGUITY_MAX_RIVAL = 0, float("inf")
            try:
                T = reloc.attempt(vol, depth, color, T_hint=hint, hint_rung=False)
            finally:
                relocalize.MIN_CONSENSUS, relocalize.AMBIGUITY_MAX_RIVAL = GATE
            err = None if T is None else [round(v * 1e3, 3) for v in _pose_err(T, truth)]
            if gated:
                out.update(consensus=list(reloc.last_consensus), accepted=T is not None,
                           reject=reloc.last_reject, err_mm_mrad=err)
            else:
                out.update(ungated_reject=reloc.last_reject, ungated_err_mm_mrad=err)
        print(json.dumps(out), flush=True)


GATE = (relocalize.MIN_CONSENSUS, relocalize.AMBIGUITY_MAX_RIVAL)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, default=2)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(4)
    intr = Intrinsics.azure_kinect_depth_nfov().scaled(args.scale)
    rays = pixel_rays(intr, dev)
    base = PipelineConfig()
    cc = base.camera.replace(depth_trunc=0.7)

    def frame(cam, T):
        d, c = cam.capture(T)
        return RGBDFrame.from_raw(torch.from_numpy(d).to(dev), torch.from_numpy(c).to(dev),
                                  cc.depth_scale, cc.depth_trunc, cc.depth_min)

    def fuse(cfg, cam, poses):
        """``poses``: (the camera's render pose, the pose fused at) pairs."""
        vol = tsdf.create(cfg.tsdf, dev)
        for T_cam, T in poses:
            f = frame(cam, T_cam)
            vol = tsdf.integrate_frame(vol, f.depth, f.color, rays,
                                       torch.as_tensor(T, dtype=torch.float32, device=dev),
                                       intr, cfg.tsdf)
        return vol

    # the corridor, as chip_smoke.py's streaming run fuses it (its plain pool)
    cfg = dataclasses.replace(base, camera=cc, tsdf=TSDFConfig(
        voxel_size=0.005, sdf_trunc=0.02, block_resolution=16, block_capacity=4096,
        hash_capacity=16384))
    cam = SyntheticCamera(scene=corridor_scene(), intrinsics=intr, device=dev)
    vol = fuse(cfg, cam, [(_x(CORRIDOR_STEP * i),) * 2 for i in range(CORRIDOR_OUT)])
    reloc = relocalize.Relocalizer(intr, cfg, device=dev, rays=rays)
    for j in CORRIDOR_LATE:
        x = DARK_X - CORRIDOR_STEP * j
        f = frame(cam, _x(x))
        _attempts("corridor", reloc, vol, f.depth, f.color, _x(DARK_X), _x(x), args.seeds,
                  {"x": round(x, 4), "frames_late": j, "device": args.device})
    # the orbit: a scene without repeats
    cfg = dataclasses.replace(base, camera=base.camera, tsdf=TSDFConfig(
        voxel_size=0.01, sdf_trunc=0.04, block_resolution=8, block_capacity=8192,
        hash_capacity=32768))
    cam = SyntheticCamera(intrinsics=intr, device=dev)
    poses = orbit_trajectory(8, radius=0.3, angle_span=0.9)
    world = [np.linalg.inv(poses[0]) @ T for T in poses]
    cc = base.camera
    vol = fuse(cfg, cam, [(poses[i], world[i]) for i in range(8) if i != 4])
    f = frame(cam, poses[4])
    reloc = relocalize.Relocalizer(intr, cfg, device=dev, rays=rays)
    hint = np.asarray(world[4], np.float64).copy()
    hint[:3, 3] += [0.9, -0.6, 0.8]
    _attempts("orbit", reloc, vol, f.depth, f.color, hint, world[4], 4 * args.seeds,
              {"device": args.device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
