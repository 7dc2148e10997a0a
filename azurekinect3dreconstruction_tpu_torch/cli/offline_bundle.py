"""Offline-optimized SLAM, headless: the port's counterpart of the JAX
package's ``scripts/offline_bundle.py``.

    python -m azurekinect3dreconstruction_tpu_torch.cli.offline_bundle \\
        --source synthetic --frames 60 --output results [--resume]

Logs every frame to ``<output>/frames`` and tracks it into a pose graph with
loop closures (``OfflineBundle``); on exit optimizes the graph, reintegrates
every logged frame at its optimized pose and saves the mesh and the
optimized trajectory. ``--resume`` rebuilds the bundle from the frame log
and pose graph in ``--output`` (the log is the checkpoint) and finalizes.
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

from azurekinect3dreconstruction_tpu_torch.cli.common import add_common_args, make_source
from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig, TSDFConfig
from azurekinect3dreconstruction_tpu_torch.pipelines.offline_bundle import OfflineBundle
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    ap.add_argument("--voxel", type=float, default=0.004, help="TSDF voxel (m; 4 mm by default)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the frame log in --output")
    args = ap.parse_args(argv)

    frames, intr = make_source(args)
    cfg = PipelineConfig(tsdf=TSDFConfig(voxel_size=args.voxel, sdf_trunc=4 * args.voxel))
    if args.resume:
        pipe = OfflineBundle.resume(intr, args.output, cfg, device=args.device)
        log_info(f"resumed with {pipe.n_frames} frames")
    else:
        pipe = OfflineBundle(intr, cfg, device=args.device, output_dir=args.output)
        try:
            for depth, color in frames:
                pipe.process_frame(depth, color)
        except KeyboardInterrupt:
            log_info("interrupted; finalizing with what we have")
    mesh = pipe.finalize()
    if mesh is not None:
        log_info(f"final mesh: {mesh.triangles.shape[0]} triangles")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
