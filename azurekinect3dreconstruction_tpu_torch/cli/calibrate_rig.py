"""Checkerboard rig calibration: the port's counterpart of the JAX
package's ``scripts/calibrate_rig.py``.

    python -m azurekinect3dreconstruction_tpu_torch.cli.calibrate_rig \\
        --source synthetic|replay:<dir>|k4a --views 10 --calib-dir calibration

N board views per camera -> per-camera Zhang/LM intrinsics -> the stereo
extrinsic mapping camera 1 into camera 0 -> a ``calib.extrinsics.
RigCalibration`` JSON under ``--calib-dir``, reloaded once with its serials
as ``cli.dual_fusion --rig-calib DIR`` will. Sources:

  synthetic      rendered board views of a rig with a known baseline
                 (camera 1 10 cm right of camera 0, toed in 0.08 rad); the
                 run fails when the baseline is over 5 cm off
  replay:<dir>   image pairs cam0_XX.npy / cam1_XX.npy saved earlier, and
                 the serials in serials.txt when it exists
  k4a            two live Azure Kinects (needs pyk4a); a color view pair
                 every --interval frames while the board moves

Host only (numpy and scipy; OpenCV when it imports): calibration is a
once-per-rig offline task and needs no card.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.calib.checkerboard import (
    calibrate_intrinsics,
    calibrate_stereo,
    render_board_view,
)
from azurekinect3dreconstruction_tpu_torch.calib.extrinsics import RigCalibration
from azurekinect3dreconstruction_tpu_torch.core import se3
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_error, log_info

SYNTH_K = np.array([[520.0, 0, 320], [0, 520, 240], [0, 0, 1]])
SYNTH_T10_XI = (0.10, 0.01, 0.0, 0.0, 0.08, 0.0)  # camera 1 of the synthetic rig


def _exp64(xi) -> np.ndarray:
    """``se3_exp`` in float32, then float64: the JAX script's truth to the bit."""
    return se3.se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy().astype(np.float64)


def synthetic_views(args):
    """Board-view pairs of a simulated rig: (views0, views1, serials, T10)."""
    T10 = _exp64(SYNTH_T10_XI)
    rng = np.random.RandomState(args.seed)
    views0, views1 = [], []
    for i in range(args.views):
        xi = np.concatenate([[0.04 * i - 0.15, 0.015 * i - 0.06, 0.55 + 0.04 * i],
                             rng.uniform(-0.22, 0.22, 3)])
        T_b0 = _exp64(xi)
        views0.append(render_board_view(SYNTH_K, T_b0, args.pattern, args.square))
        views1.append(render_board_view(SYNTH_K, np.linalg.inv(T10) @ T_b0, args.pattern,
                                        args.square))
    return views0, views1, ["SYNTH0", "SYNTH1"], T10


def replay_views(directory):
    views0, views1 = [], []
    for f0 in sorted(glob.glob(os.path.join(directory, "cam0_*.npy"))):
        f1 = f0.replace("cam0_", "cam1_")
        if os.path.exists(f1):
            views0.append(np.load(f0))
            views1.append(np.load(f1))
    serials = ["REPLAY0", "REPLAY1"]
    sfile = os.path.join(directory, "serials.txt")
    if os.path.exists(sfile):
        with open(sfile) as f:
            serials = f.read().split()
    return views0, views1, serials, None


def k4a_views(args):
    from azurekinect3dreconstruction_tpu_torch.io.k4a_live import K4ALiveSource, detect_cameras
    from azurekinect3dreconstruction_tpu_torch.io.streams import MultiCameraRig

    ids = detect_cameras()
    if len(ids) < 2:
        raise SystemExit("need two Azure Kinect devices for --source k4a")
    sources = [K4ALiveSource(device_id=i) for i in ids[:2]]
    serials = [s.serial for s in sources]
    rig = MultiCameraRig([s.capture for s in sources])
    rig.start()
    rig.install_sigint_handler()
    views0, views1 = [], []
    try:
        n = 0
        log_info(f"capturing {args.views} board views, one every {args.interval} frames: move "
                 "the board between views")
        while len(views0) < args.views:
            frames = rig.get_synchronized_frames()
            if frames is None:
                continue
            n += 1
            if n % args.interval:
                continue
            views0.append(np.asarray(frames[0][1]))  # color images
            views1.append(np.asarray(frames[1][1]))
            log_info(f"view {len(views0)}/{args.views}")
    finally:
        rig.stop()
        for s in sources:
            s.stop()
    return views0, views1, serials, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default="synthetic", help="synthetic | replay:<dir> | k4a")
    ap.add_argument("--views", type=int, default=10, help="board views per camera")
    ap.add_argument("--pattern", default="9x6", help="inner-corner grid, e.g. 9x6")
    ap.add_argument("--square", type=float, default=0.025, help="checker square size (m)")
    ap.add_argument("--interval", type=int, default=30, help="k4a: frames between views")
    ap.add_argument("--calib-dir", default="calibration", help="output directory of the JSON")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    args.pattern = tuple(int(x) for x in args.pattern.split("x"))

    if args.source == "synthetic":
        views0, views1, serials, T_true = synthetic_views(args)
    elif args.source.startswith("replay:"):
        views0, views1, serials, T_true = replay_views(args.source.split(":", 1)[1])
    elif args.source == "k4a":
        views0, views1, serials, T_true = k4a_views(args)
    else:
        raise SystemExit(f"unknown source {args.source!r}: use synthetic, replay:<dir> or k4a")
    if len(views0) < 3:
        log_error(f"only {len(views0)} view pairs: need >= 3")
        return 1

    t0 = time.perf_counter()
    out0 = calibrate_intrinsics(views0, args.pattern, args.square)
    out1 = calibrate_intrinsics(views1, args.pattern, args.square)
    if out0 is None or out1 is None:
        log_error("intrinsic calibration failed (not enough detected boards)")
        return 1
    intr0, dist0, rms0 = out0
    intr1, dist1, rms1 = out1
    st = calibrate_stereo(views0, views1, intr0, dist0, intr1, dist1, args.pattern, args.square)
    if st is None:
        log_error("stereo calibration failed")
        return 1
    T10, rms_st = st
    ms = (time.perf_counter() - t0) * 1e3

    cal = RigCalibration(serials, [np.eye(4), T10], meta={
        "rms_intrinsics": [rms0, rms1],
        "rms_stereo": rms_st,
        "pattern": list(args.pattern),
        "square_size": args.square,
        "intrinsics": [[intr0.fx, intr0.fy, intr0.cx, intr0.cy],
                       [intr1.fx, intr1.fy, intr1.cx, intr1.cy]],
    })
    path = cal.save(args.calib_dir)
    # the round trip with the serial check that dual_fusion --rig-calib makes
    if RigCalibration.load_newest(args.calib_dir, expected_serials=serials) is None:
        log_error(f"the saved calibration {path} does not reload")
        return 1
    log_info(f"baseline {np.linalg.norm(T10[:3, 3]):.4f} m, stereo rms {rms_st:.3f} px -> "
             f"{path} (calibration {ms:.1f} ms, host)")
    if T_true is not None:
        err = np.linalg.norm(T10[:3, 3] - T_true[:3, 3])
        log_info(f"synthetic ground-truth baseline error: {err * 1000:.1f} mm")
        if err > 0.05:
            log_error("calibration error exceeds 5 cm on synthetic data")
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
