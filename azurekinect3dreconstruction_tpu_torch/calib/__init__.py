"""Camera-rig calibration: checkerboard intrinsics and stereo extrinsics,
and the rig calibration files ``cli.dual_fusion --rig-calib`` reads."""

from azurekinect3dreconstruction_tpu_torch.calib.checkerboard import (
    calibrate_intrinsics,
    calibrate_stereo,
    find_corners,
    generate_checkerboard,
)
from azurekinect3dreconstruction_tpu_torch.calib.extrinsics import RigCalibration
