"""Depth -> point-cloud converter with recording, headless: the port's
counterpart of the JAX package's ``scripts/depth_to_cloud.py``.

    python -m azurekinect3dreconstruction_tpu_torch.cli.depth_to_cloud \\
        --source synthetic --frames 20 --save-every 10 [--record] --output results

Decodes every frame and back-projects it to a colored cloud in the camera
frame; every ``--save-every``-th is written as PLY (``cloud``). ``--record``
also logs each raw frame to ``<output>/frames`` as ``frame_%06d.npz``, the
format ``--source replay:<dir>`` reads. Runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import os

from azurekinect3dreconstruction_tpu_torch.cli.common import add_common_args, make_source
from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device, upload
from azurekinect3dreconstruction_tpu_torch.core.types import PointCloudHost, RGBDFrame
from azurekinect3dreconstruction_tpu_torch.io.replay import FrameRecorder
from azurekinect3dreconstruction_tpu_torch.ops.backproject import backproject_depth
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info
from azurekinect3dreconstruction_tpu_torch.viz.savers import ResultSaver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    ap.add_argument("--record", action="store_true",
                    help="also log the raw frames as npz (frames/ subdirectory)")
    ap.add_argument("--save-every", type=int, default=10, help="write a PLY every N frames")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    frames, intr = make_source(args)
    rays = pixel_rays(intr, dev)
    saver = ResultSaver(args.output)
    rec = FrameRecorder(os.path.join(args.output, "frames")) if args.record else None
    for i, (depth, color) in enumerate(frames):
        if rec is not None:
            rec.write(depth, color)
        if i % args.save_every:
            continue
        frame = RGBDFrame.from_raw(upload(depth, dev), upload(color, dev))
        pts = backproject_depth(frame.depth, rays).reshape(-1, 3)
        m = pts[:, 2] > 0
        path = saver.save_point_cloud(PointCloudHost(
            points=pts[m].cpu().numpy(), colors=frame.color.reshape(-1, 3)[m].cpu().numpy()),
            kind="cloud")
        log_info(f"frame {i}: {int(m.sum())} points -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
