"""Colored-ICP recording reconstructor, headless: the port's counterpart of
the JAX package's ``scripts/record_reconstruction.py``.

    python -m azurekinect3dreconstruction_tpu_torch.cli.record_reconstruction \\
        --source synthetic --frames 60 --output results

Records every frame (``Recorder``: keyframe colored-ICP tracking with the
fallback ladder, every recorded frame integrated) and on exit saves the
mesh, the volume's point cloud and the trajectory. A headless run records
from the first frame, as the JAX script's does (``--autostart`` says so
explicitly). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

from azurekinect3dreconstruction_tpu_torch.cli.common import add_common_args, make_source
from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig, TSDFConfig
from azurekinect3dreconstruction_tpu_torch.pipelines.recorder import Recorder
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    ap.add_argument("--voxel", type=float, default=0.01, help="TSDF voxel (m)")
    ap.add_argument("--autostart", action="store_true",
                    help="start recording immediately (a headless run always does)")
    args = ap.parse_args(argv)

    frames, intr = make_source(args)
    cfg = PipelineConfig(tsdf=TSDFConfig(voxel_size=args.voxel, sdf_trunc=4 * args.voxel))
    pipe = Recorder(intr, cfg, device=args.device, output_dir=args.output)
    pipe.toggle_recording()
    for depth, color in frames:
        pipe.process_frame(depth, color)
    paths = pipe.save_model()
    log_info(f"{pipe.frame_index} frames recorded; saved {', '.join(sorted(paths))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
