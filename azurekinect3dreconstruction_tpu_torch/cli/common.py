"""Shared command-line plumbing of the port's entry points (the counterpart
of the JAX package's ``scripts/common.py``, headless only).

``--source`` chooses the frames:
  synthetic       the deterministic rendered scene (default; no hardware)
  replay:<dir>    a recorded ``frame_%06d.npz`` log (``io/replay.py``)
"""

from __future__ import annotations

import argparse
from typing import Iterator, Tuple

import numpy as np

from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device
from azurekinect3dreconstruction_tpu_torch.io.replay import NpzReplaySource
from azurekinect3dreconstruction_tpu_torch.io.synthetic import SyntheticCamera, orbit_trajectory
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--source", default="synthetic", help="synthetic | replay:<dir>")
    ap.add_argument("--frames", type=int, default=60, help="frame budget")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="intrinsics and image scale of the synthetic source (e.g. 0.25)")
    ap.add_argument("--output", default="results", help="output directory")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels; raises without a card) or cpu "
                         "(their plain PyTorch versions)")


def make_source(args) -> Tuple[Iterator[Tuple[np.ndarray, np.ndarray]], Intrinsics]:
    """(raw frame iterator, depth intrinsics). The synthetic source renders
    on ``args.device`` and sets ``args.gt_poses``, its true poses."""
    spec = args.source
    if spec == "synthetic":
        intr = Intrinsics.azure_kinect_depth_nfov().scaled(args.scale)
        cam = SyntheticCamera(intrinsics=intr, device=resolve_device(args.device))
        poses = orbit_trajectory(args.frames, radius=0.35, angle_span=1.0)
        args.gt_poses = [np.asarray(T, np.float64) for T in poses]
        return (cam.capture(T) for T in poses), intr
    if spec.startswith("replay:"):
        src = NpzReplaySource(spec.split(":", 1)[1], limit=args.frames or None)
        intr = src.calibration.depth if src.calibration else Intrinsics.azure_kinect_depth_nfov()
        if args.scale != 1.0:
            log_info("--scale ignored for replay sources")
        return iter(src), intr
    raise SystemExit(f"unknown source {spec!r}: use synthetic or replay:<dir>")
