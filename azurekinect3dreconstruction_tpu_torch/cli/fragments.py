"""Staged fragment reconstruction, headless: the port's counterpart of the
JAX package's ``scripts/fragments.py``.

    python -m azurekinect3dreconstruction_tpu_torch.cli.fragments \\
        --source synthetic --frames 60 --capture-every 10 --output results

Captures every ``--capture-every``-th frame, then runs the stages of
``FragmentPipeline`` (fragments, registration, scene integration) and
saves the scene mesh as ``fragments_mesh``. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse

from azurekinect3dreconstruction_tpu_torch.cli.common import add_common_args, make_source
from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig, TSDFConfig
from azurekinect3dreconstruction_tpu_torch.pipelines.fragments import FragmentPipeline
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info
from azurekinect3dreconstruction_tpu_torch.viz.savers import ResultSaver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    ap.add_argument("--voxel", type=float, default=0.01, help="TSDF voxel (m)")
    ap.add_argument("--capture-every", type=int, default=10, help="capture every N frames")
    args = ap.parse_args(argv)

    frames, intr = make_source(args)
    cfg = PipelineConfig(tsdf=TSDFConfig(voxel_size=args.voxel, sdf_trunc=3 * args.voxel))
    pipe = FragmentPipeline(intr, cfg, device=args.device)
    for i, (depth, color) in enumerate(frames):
        if i % args.capture_every == 0:
            pipe.capture(depth, color)
    mesh = pipe.run()
    ResultSaver(args.output).save_mesh(mesh, kind="fragments_mesh")
    log_info(f"fragment mesh: {mesh.triangles.shape[0]} triangles from "
             f"{len(pipe.fragments)} fragments")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
