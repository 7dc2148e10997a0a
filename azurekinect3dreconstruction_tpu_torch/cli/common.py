"""Shared command-line plumbing of the port's entry points (the counterpart
of the JAX package's ``scripts/common.py``).

``--source`` chooses the frames:
  synthetic       the deterministic rendered scene (default; no hardware)
  replay:<dir>    a recorded ``frame_%06d.npz`` log (``io/replay.py``)
  mkv:<file>      a k4arecorder recording (``io/mkv.py``; needs pyk4a)
  k4a[:<id>]      a live Azure Kinect (``io/k4a_live.py``; needs pyk4a)

The MKV and live sources give depth registered to the color camera, so
their intrinsics are the color camera's, at the size the recording or the
configured color resolution gives the frames. Without pyk4a they exit with
an error that says so.

The live entry points show their reconstruction through :func:`make_viewer`:
``--serve PORT`` serves it to a browser (``viz.live_server``), else an
Open3D window opens when Open3D imports and ``--headless`` is not given,
else nothing is shown.
"""

from __future__ import annotations

import argparse
import itertools
from typing import Iterator, Tuple

import numpy as np

from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device
from azurekinect3dreconstruction_tpu_torch.io.replay import NpzReplaySource
from azurekinect3dreconstruction_tpu_torch.io.synthetic import SyntheticCamera, orbit_trajectory
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--source", default="synthetic", help="synthetic | replay:<dir> | mkv:<file> | k4a[:<id>]")
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
    try:
        if spec.startswith("mkv:"):
            from azurekinect3dreconstruction_tpu_torch.io.mkv import MkvReplaySource

            src = MkvReplaySource(spec.split(":", 1)[1], limit=args.frames or None)
            return iter(src), src.calibration.color
        if spec == "k4a" or spec.startswith("k4a:"):
            from azurekinect3dreconstruction_tpu_torch.io.k4a_live import K4ALiveSource

            src = K4ALiveSource(device_id=int(spec.split(":")[1]) if ":" in spec else 0)
            it = itertools.islice(src.frames(), args.frames) if args.frames else src.frames()
            return it, src.calibration.color
    except RuntimeError as e:
        raise SystemExit(f"--source {spec}: {e}") from e
    raise SystemExit(f"unknown source {spec!r}: use synthetic, replay:<dir>, mkv:<file> or "
                     "k4a[:<id>]")


def add_viewer_args(ap: argparse.ArgumentParser) -> None:
    """``--headless`` and ``--serve PORT`` of the live entry points."""
    ap.add_argument("--headless", action="store_true", help="never open a window")
    ap.add_argument("--serve", type=int, nargs="?", const=0, default=None, metavar="PORT",
                    help="serve a live browser viewer on 127.0.0.1:PORT (0 = any free port) "
                         "instead of an Open3D window; works headless")


class NullViewer:
    """The viewer when nothing is shown: keys are never pressed, geometry
    goes nowhere, the loop never stops early."""

    headless = True

    def register_key(self, *a, **k):
        pass

    def press(self, *a):
        pass

    def update_cloud(self, *a):
        pass

    def update_mesh(self, *a):
        pass

    def tick(self) -> bool:
        return True

    def close(self):
        pass

    def reset_view(self):
        pass


def make_viewer(args, name: str):
    """A ``viz.live_server.BrowserLiveViewer`` on ``--serve PORT``; else
    Open3D's window (``viz.o3d_bridge.LiveViewer``) when Open3D imports and
    ``--headless`` is not given; else a :class:`NullViewer`."""
    from azurekinect3dreconstruction_tpu_torch.viz import o3d_bridge

    if getattr(args, "serve", None) is not None:
        from azurekinect3dreconstruction_tpu_torch.viz.live_server import BrowserLiveViewer

        return BrowserLiveViewer(port=args.serve, window_name=name)
    if getattr(args, "headless", False) or not o3d_bridge.is_available():
        return NullViewer()
    return o3d_bridge.LiveViewer(window_name=name)
