"""How often the port's accumulator coarse stage ends rejected.

    python tools/torch_coarse_seed_rate.py --device cpu

Runs the large-motion pair of ``tests/test_pipelines.py``'s
``test_cloud_accumulator_coarse_recovers_large_motion`` (two sweep poses
1.3 rad apart on a 0.45 m orbit, quarter resolution, that test's
SMALL_CFG) through the port's ``CloudAccumulator`` once for each generator
seed 0-19. For each seed it prints the rounds the coarse stage drew
(``coarse_retry`` + 1), whether a seed won, whether the keyframe was
rejected (``reg_fail``), the pose error against the truth and whether it
lies within the test's bounds (< 6 cm / 0.10 rad); then one JSON line with
the totals. Runs on the card unless ``--device cpu``; on the CPU it
keeps torch to 2 threads. Needs no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from azurekinect3dreconstruction_tpu_torch.config import (  # noqa: E402
    OdometryConfig,
    PipelineConfig,
    RegistrationConfig,
    TSDFConfig,
)
from azurekinect3dreconstruction_tpu_torch.core import se3  # noqa: E402
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics  # noqa: E402
from azurekinect3dreconstruction_tpu_torch.io.synthetic import (  # noqa: E402
    SyntheticCamera,
    orbit_trajectory,
)
from azurekinect3dreconstruction_tpu_torch.pipelines.cloud_accumulator import (  # noqa: E402
    CloudAccumulator,
)

# tests/test_pipelines.py's SMALL_CFG
CFG = PipelineConfig(
    tsdf=TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8, block_capacity=2048,
                    hash_capacity=8192),
    odometry=OdometryConfig(pyramid_iters=(8, 8, 8)),
    registration=RegistrationConfig(ransac_hypotheses=1024, icp_max_iters=20,
                                    colored_icp_max_iters=30),
    keyframe_interval=1,
    vis_update_interval=2,
)
T_LIMIT_M, R_LIMIT_RAD = 0.06, 0.10
SEEDS = 20
CPU_THREADS = 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(CPU_THREADS)
    intr = Intrinsics.azure_kinect_depth_nfov().scaled(0.25)
    cam = SyntheticCamera(intrinsics=intr, device=args.device)
    poses = orbit_trajectory(2, radius=0.45, angle_span=1.3, height_wobble=0.0)
    frames = [cam.capture(T) for T in poses]
    T_true = np.linalg.inv(poses[0]) @ poses[1]
    rows = []
    with tempfile.TemporaryDirectory() as out:
        for seed in range(SEEDS):
            t0 = time.perf_counter()
            pipe = CloudAccumulator(intr, CFG, device=args.device, output_dir=out)
            pipe.generator.manual_seed(seed)
            for d, c in frames:
                pipe.process_frame(d, c)
            ev = pipe.telemetry.counters
            xi = se3.se3_log(torch.as_tensor(np.linalg.inv(T_true) @ pipe.T_world_cam,
                                             dtype=torch.float32))
            et, er = float(xi[:3].norm()), float(xi[3:].norm())
            row = dict(seed=seed, rounds=ev.get("coarse_retry", 0) + 1,
                       won=ev.get("coarse_won", 0), rejected=ev.get("reg_fail", 0) > 0,
                       t_err_m=et, r_err_rad=er, within=et < T_LIMIT_M and er < R_LIMIT_RAD,
                       s=time.perf_counter() - t0)
            rows.append(row)
            print(json.dumps(row), flush=True)
    failed = [r["seed"] for r in rows if r["rejected"] or not r["within"]]
    rounds = [r["rounds"] for r in rows]
    print(json.dumps({"seeds": len(rows), "failed": len(failed), "failed_seeds": failed,
                      "rejected": sum(r["rejected"] for r in rows),
                      "rounds_histogram": {str(k): rounds.count(k) for k in sorted(set(rounds))},
                      "device": str(args.device)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
