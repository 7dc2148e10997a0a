"""Point-cloud accumulation reconstructor (no TSDF), headless: the port's
counterpart of the JAX package's ``scripts/cloud_accumulate.py``.

    python -m azurekinect3dreconstruction_tpu_torch.cli.cloud_accumulate \\
        --source synthetic --frames 60 --keyframe-interval 2 --output results

Registers every keyframe to the last (projective ICP, seeded by FPFH +
RANSAC where the unseeded fit is poor) and grows a global colored model
(``CloudAccumulator``); on exit saves the normal-oriented model cloud and,
with ``--poisson`` and Open3D installed, a Poisson mesh with the cloud's
colors. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses

from azurekinect3dreconstruction_tpu_torch.cli.common import add_common_args, make_source
from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig
from azurekinect3dreconstruction_tpu_torch.pipelines.cloud_accumulator import CloudAccumulator
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    ap.add_argument("--keyframe-interval", type=int, default=None,
                    help="register every N frames (default: the config's 10)")
    ap.add_argument("--no-coarse", action="store_true",
                    help="skip the FPFH + RANSAC seed (smooth dense streams)")
    ap.add_argument("--poisson", action="store_true",
                    help="also save a Poisson mesh with transferred colors (needs Open3D)")
    args = ap.parse_args(argv)

    frames, intr = make_source(args)
    cfg = PipelineConfig()
    if args.keyframe_interval:
        cfg = dataclasses.replace(cfg, keyframe_interval=args.keyframe_interval)
    pipe = CloudAccumulator(intr, cfg, device=args.device, output_dir=args.output,
                            coarse=not args.no_coarse)
    for depth, color in frames:
        pipe.process_frame(depth, color)
    paths = pipe.save_model(poisson=args.poisson)
    log_info(f"saved model: {', '.join(sorted(paths))} ({pipe.model_points.shape[0]} points)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
