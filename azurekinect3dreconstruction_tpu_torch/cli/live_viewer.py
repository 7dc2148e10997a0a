"""Plain live RGB point-cloud viewer: the port's counterpart of the JAX
package's ``scripts/live_viewer.py``.

    python -m azurekinect3dreconstruction_tpu_torch.cli.live_viewer \\
        --source synthetic --frames 60 [--serve 8000] [--position-colors]

Decodes and back-projects every frame on ``--device`` (the card unless
``--device cpu``) and shows the valid points, colored by the frame's RGB or,
with ``--position-colors``, by their XYZ position, until the frames end or
the viewer closes (``--serve``, ``--headless`` and the Open3D window as in
``cli.live_mono``).
"""

from __future__ import annotations

import argparse

import numpy as np

from azurekinect3dreconstruction_tpu_torch.cli.common import (
    add_common_args,
    add_viewer_args,
    make_source,
    make_viewer,
)
from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device, upload
from azurekinect3dreconstruction_tpu_torch.core.types import PointCloudHost, RGBDFrame
from azurekinect3dreconstruction_tpu_torch.ops.backproject import backproject_depth
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info


def colorize_by_position(pts: np.ndarray) -> np.ndarray:
    """XYZ -> RGB: each coordinate scaled to [0, 1] over the cloud's bounds."""
    lo, hi = pts.min(0), pts.max(0)
    return np.clip((pts - lo) / np.maximum(hi - lo, 1e-6), 0, 1).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    add_viewer_args(ap)
    ap.add_argument("--position-colors", action="store_true",
                    help="color by XYZ position instead of RGB")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    frames, intr = make_source(args)
    rays = pixel_rays(intr, dev)
    viewer = make_viewer(args, "live viewer")
    n = 0
    try:
        for depth, color in frames:
            frame = RGBDFrame.from_raw(upload(depth, dev), upload(color, dev))
            pts = backproject_depth(frame.depth, rays).reshape(-1, 3)
            m = pts[:, 2] > 0
            pts = pts[m].cpu().numpy()
            cols = (colorize_by_position(pts) if args.position_colors
                    else frame.color.reshape(-1, 3)[m].cpu().numpy())
            viewer.update_cloud("live", PointCloudHost(points=pts, colors=cols))
            n += 1
            if not viewer.tick():
                break
    finally:
        viewer.close()
    log_info(f"{n} frames shown, the last with {pts.shape[0] if n else 0} points")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
