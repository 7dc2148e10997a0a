"""Calibration-pattern generator: the port's counterpart of the JAX
package's ``scripts/generate_checkerboard.py``.

    python -m azurekinect3dreconstruction_tpu_torch.cli.generate_checkerboard \\
        --cols 10 --rows 7 --sizes 60 100 140 --output calibration

Writes one board of ``--cols`` x ``--rows`` squares (50 px margin) per
square size: a PNG through OpenCV when it imports, else the u8 array as
``.npy``. Host only.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from azurekinect3dreconstruction_tpu_torch.calib.checkerboard import generate_checkerboard
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cols", type=int, default=10)
    ap.add_argument("--rows", type=int, default=7)
    ap.add_argument("--sizes", type=int, nargs="+", default=[60, 100, 140],
                    help="square sizes in px (one file each)")
    ap.add_argument("--output", default="calibration")
    args = ap.parse_args(argv)

    os.makedirs(args.output, exist_ok=True)
    for s in args.sizes:
        img = generate_checkerboard(args.cols, args.rows, s)
        path = os.path.join(args.output, f"checkerboard_{args.cols}x{args.rows}_{s}px.png")
        try:
            import cv2

            cv2.imwrite(path, img)
        except ImportError:
            path = path.replace(".png", ".npy")
            np.save(path, img)
        log_info(f"wrote {path} ({img.shape[1]}x{img.shape[0]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
