"""Two-camera fusion with auto-calibration, headless: the port's counterpart
of the JAX package's ``scripts/dual_fusion.py``.

    python -m azurekinect3dreconstruction_tpu_torch.cli.dual_fusion \\
        --source synthetic|k4a --frames 30 [--sharded] --output results

The synthetic source is a static two-camera rig viewing the default scene:
camera 0 at the origin, camera 1 at ``se3_exp([0.12, 0.02, -0.02, 0.03,
-0.1, 0.02])``. ``--source k4a`` captures synchronized pairs from the first
two attached Azure Kinects (``io.streams.MultiCameraRig`` over two
``io.k4a_live.K4ALiveSource``; needs pyk4a), each camera with its own
color calibration. Each pair uploads while the previous one
computes (``io.streams.prefetch_to_device``). The first good pair calibrates camera 1's extrinsic (FPFH +
RANSAC + ICP; ``--colored-calib`` refines with colored ICP), unless
``--rig-calib DIR`` loads the newest rig calibration there; a run that no
pair calibrated names that route in its summary line. Every pair is
fused (``DualCameraFusion``); on exit the merged cloud and the TSDF mesh
are saved and the extrinsic's roll, pitch and yaw logged. ``--sharded``
puts each camera on its own row of a grid of the visible cards with the
volume block-sharded over its columns; with fewer than two cards it logs
a warning and runs unsharded. Runs on the card unless ``--device cpu``.

``--serve PORT`` shows the merged cloud in a browser (``viz.live_server``),
else an Open3D window opens when Open3D imports and ``--headless`` is not
given; the cloud is refreshed every ``vis_update_interval`` pairs. Keys: S
save, R recalibrate, C cycle the color mode.
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.calib.extrinsics import RigCalibration
from azurekinect3dreconstruction_tpu_torch.cli.common import (
    add_common_args,
    add_viewer_args,
    make_viewer,
)
from azurekinect3dreconstruction_tpu_torch.config import (
    PipelineConfig,
    RegistrationConfig,
    TSDFConfig,
)
from azurekinect3dreconstruction_tpu_torch.core import se3
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device
from azurekinect3dreconstruction_tpu_torch.io.streams import MultiCameraRig, prefetch_to_device
from azurekinect3dreconstruction_tpu_torch.io.synthetic import SyntheticCamera
from azurekinect3dreconstruction_tpu_torch.pipelines.dual_fusion import (
    RIG_CALIB_ADVICE,
    DualCameraFusion,
)
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info

RIG_XI = (0.12, 0.02, -0.02, 0.03, -0.1, 0.02)  # camera 1 of the synthetic rig


def synthetic_pair_frames(args, intr):
    """The static synthetic rig's raw pairs, ``args.frames`` of them."""
    cam = SyntheticCamera(intrinsics=intr, device=resolve_device(args.device))
    T1 = se3.se3_exp(torch.tensor(RIG_XI, dtype=torch.float32)).numpy().astype(np.float64)
    for _ in range(args.frames):
        yield cam.capture(np.eye(4)), cam.capture(T1)


def k4a_pair_frames(args):
    """(pairs from the first two attached Azure Kinects through a
    synchronized rig, (camera 0's, camera 1's) color intrinsics: the frames'
    depth is registered to each camera's own color camera)."""
    from azurekinect3dreconstruction_tpu_torch.io.k4a_live import K4ALiveSource, detect_cameras

    ids = detect_cameras()
    if len(ids) < 2:
        raise SystemExit("need two Azure Kinect devices for --source k4a")
    sources = [K4ALiveSource(device_id=i) for i in ids[:2]]

    def pairs():
        rig = MultiCameraRig([s.capture for s in sources])
        rig.start()
        rig.install_sigint_handler()
        try:
            n = 0
            while args.frames == 0 or n < args.frames:
                frames = rig.get_synchronized_frames()
                if frames is not None:
                    yield tuple(frames)
                    n += 1
        finally:
            rig.stop()
            for s in sources:
                s.stop()

    return pairs(), (sources[0].calibration.color, sources[1].calibration.color)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    add_viewer_args(ap)
    ap.add_argument("--voxel", type=float, default=0.01, help="TSDF voxel (m)")
    ap.add_argument("--sharded", action="store_true",
                    help="camera-per-device + block-sharded volume over the visible cards "
                         "(needs >= 2; falls back to one device with a warning)")
    ap.add_argument("--colored-calib", action="store_true",
                    help="refine the auto-calibration extrinsic with colored ICP (locks the "
                         "in-plane freedom a textured flat wall leaves point-to-plane)")
    ap.add_argument("--rig-calib", default=None, metavar="DIR",
                    help="load the newest rig calibration from DIR instead of auto-calibrating")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(levelname)s] %(message)s")
    if args.source == "k4a":
        frames, intrs = k4a_pair_frames(args)
    elif args.source == "synthetic":
        intr = Intrinsics.azure_kinect_depth_nfov().scaled(args.scale)
        frames, intrs = synthetic_pair_frames(args, intr), (intr, intr)
    else:
        raise SystemExit(f"dual_fusion takes --source synthetic or k4a (a {args.source!r} source "
                         "holds one camera)")
    cfg = PipelineConfig(tsdf=TSDFConfig(voxel_size=args.voxel, sdf_trunc=4 * args.voxel),
                         registration=RegistrationConfig(ransac_hypotheses=2048))
    pipe = DualCameraFusion(intrs, cfg, device=args.device, output_dir=args.output,
                            sharded=args.sharded, colored_calibration=args.colored_calib)
    if args.rig_calib:
        serials = None
        if args.source == "k4a":  # the saved serials must match the attached rig's
            from azurekinect3dreconstruction_tpu_torch.io.k4a_live import rig_serials

            serials = rig_serials()
        cal = RigCalibration.load_newest(args.rig_calib, expected_serials=serials)
        if cal is None:
            raise SystemExit(f"no matching rig calibration in {args.rig_calib}")
        pipe.extrinsics = [np.asarray(e, np.float64) for e in cal.extrinsics]
        pipe.calibrated = True
        log_info(f"rig calibration loaded: baseline "
                 f"{np.linalg.norm(cal.extrinsics[1][:3, 3]):.4f} m (serials {cal.serials})")
    viewer = make_viewer(args, "dual-camera fusion")
    try:
        viewer.register_key("S", pipe.save_current_state, "save cloud + mesh")
        viewer.register_key("R", pipe.recalibrate, "recalibrate extrinsics (ICP)")
        viewer.register_key("C", pipe.cycle_color_mode, "cycle color mode")
        for i, pair in enumerate(prefetch_to_device(frames, device=args.device)):
            pipe.process_frames(pair)
            if i % cfg.vis_update_interval == 0 and not viewer.headless:
                viewer.update_cloud("merged", pipe.merged_cloud())
            if not viewer.tick():
                break
        log_info(f"{pipe.frame_index} pairs, calibrated {pipe.calibrated}, sharded "
                 f"{pipe.sharded}, n_blocks {int(pipe.volume.n_blocks.sum())}, "
                 f"overflow {bool(pipe.volume.overflow.any())}, "
                 f"calibration events {json.dumps(pipe.counts)}"
                 + ("" if pipe.calibrated else f"; no pair calibrated: {RIG_CALIB_ADVICE}"))
        pipe.save_current_state()
    finally:
        viewer.close()
    if pipe.calibrated:
        r, p, y = se3.rpy_from_matrix(pipe.extrinsics[1][:3, :3])
        log_info(f"final extrinsic rpy deg: {np.degrees([r, p, y])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
