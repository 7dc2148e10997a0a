"""Hardware and environment smoke test: the port's counterpart of the JAX
package's ``scripts/device_test.py``.

    python -m azurekinect3dreconstruction_tpu_torch.cli.device_test \\
        [--source auto|k4a|synthetic] [--device cuda|cpu]

Reports the first attached Azure Kinect's depth and color shapes (with
pyk4a and a camera), or else the synthetic camera's, then the torch device
and a small matrix product on it. Runs on the card unless ``--device cpu``
(and raises without one).
"""

from __future__ import annotations

import argparse

import torch

from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device
from azurekinect3dreconstruction_tpu_torch.io import k4a_live
from azurekinect3dreconstruction_tpu_torch.io.synthetic import SyntheticCamera
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default="auto", choices=["auto", "k4a", "synthetic"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log_info(f"torch {torch.__version__}, device {dev} ({name}), "
             f"{torch.cuda.device_count()} CUDA device(s) visible")

    camera_seen = False
    if args.source in ("auto", "k4a") and k4a_live.is_available():
        ids = k4a_live.detect_cameras()
        log_info(f"k4a devices: {ids}")
        if ids:
            src = k4a_live.K4ALiveSource(ids[0])
            try:
                d, c = next(src.frames())
            finally:
                src.stop()
            log_info(f"depth {d.shape} {d.dtype}; color {c.shape} {c.dtype}")
            camera_seen = True
    if not camera_seen:
        log_info("no camera; exercising the synthetic source")
        cam = SyntheticCamera(intrinsics=Intrinsics.azure_kinect_depth_nfov(), device=dev)
        d, c = cam.capture()
        log_info(f"depth {d.shape} {d.dtype} (max {d.max()}mm); color {c.shape} {c.dtype}")

    x = torch.ones((256, 256), device=dev)
    log_info(f"device matmul OK: {float((x @ x).sum())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
