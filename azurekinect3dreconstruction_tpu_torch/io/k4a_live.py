"""Optional live Azure Kinect capture through pyk4a, imported only when
used (the counterpart of the JAX package's ``io/k4a_live.py``).

The device layer: the NFOV_UNBINNED configuration with synchronized color
and depth, an init ladder across pyk4a API variants, device enumeration by
index, serial numbers for rig-calibration checks, calibration-matrix
probing with the width * 1.03 fallback, and BGRA -> RGB with
``transformed_depth`` (depth registered to the color camera). Frames are
host numpy arrays. The intrinsics carry the sizes of the configured color
resolution and depth mode (:func:`mode_sizes`); pyk4a's calibration
matrices are those of the configured modes.

Without pyk4a, ``is_available()`` is False, ``detect_cameras()`` finds
nothing and ``K4ALiveSource`` raises a ``RuntimeError``; the replay and
synthetic sources serve every pipeline instead.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from azurekinect3dreconstruction_tpu_torch.core.camera import CameraCalibration, Intrinsics
from azurekinect3dreconstruction_tpu_torch.io.replay import FrameSource
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info, log_warning


# (width, height) of each pyk4a color resolution and depth mode
COLOR_SIZES = {"RES_720P": (1280, 720), "RES_1080P": (1920, 1080), "RES_1440P": (2560, 1440),
               "RES_1536P": (2048, 1536), "RES_2160P": (3840, 2160), "RES_3072P": (4096, 3072)}
DEPTH_SIZES = {"NFOV_2X2BINNED": (320, 288), "NFOV_UNBINNED": (640, 576),
               "WFOV_2X2BINNED": (512, 512), "WFOV_UNBINNED": (1024, 1024),
               "PASSIVE_IR": (1024, 1024)}


def mode_name(mode) -> str:
    """``RES_1080P`` for ``ColorResolution.RES_1080P``, its name, or a string."""
    return str(getattr(mode, "name", mode)).rsplit(".", 1)[-1]


def mode_sizes(color_resolution, depth_mode) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((color width, height), (depth width, height)) of a k4a configuration;
    each mode a pyk4a enum member or its name. ``ValueError`` for a mode
    with no image (``OFF``): the color-aligned frames need both cameras."""
    c, d = mode_name(color_resolution), mode_name(depth_mode)
    if c not in COLOR_SIZES or d not in DEPTH_SIZES:
        raise ValueError(f"color-aligned frames need a color resolution of {list(COLOR_SIZES)} "
                         f"and a depth mode of {list(DEPTH_SIZES)}; got {c} and {d}")
    return COLOR_SIZES[c], DEPTH_SIZES[d]


def calibration_from_matrices(cal, color_size, depth_size, serial: str) -> CameraCalibration:
    """The color and depth intrinsics from a pyk4a ``Calibration`` (which
    holds the matrices of the configured modes), at the given sizes."""
    m = np.asarray(cal.get_camera_matrix(1))  # color camera
    md = np.asarray(cal.get_camera_matrix(0))  # depth camera
    color = Intrinsics(*color_size, float(m[0, 0]), float(m[1, 1]), float(m[0, 2]),
                       float(m[1, 2]))
    depth = Intrinsics(*depth_size, float(md[0, 0]), float(md[1, 1]), float(md[0, 2]),
                       float(md[1, 2]))
    return CameraCalibration(depth=depth, color=color, serial=serial)


def fallback_calibration(color_size, depth_size, serial: str) -> CameraCalibration:
    """The nominal model's depth intrinsics (NFOV_UNBINNED; the width *
    1.03 guess at any other depth size) and the width * 1.03 color guess,
    each at its real size."""
    nominal = CameraCalibration.azure_kinect_nominal(serial)
    depth = (nominal.depth if depth_size == (nominal.depth.width, nominal.depth.height)
             else Intrinsics.fallback_from_size(*depth_size))
    return CameraCalibration(depth=depth, color=Intrinsics.fallback_from_size(*color_size),
                             serial=serial)


def _pyk4a():
    try:
        import pyk4a  # noqa

        return pyk4a
    except ImportError:
        return None


def is_available() -> bool:
    return _pyk4a() is not None


def detect_cameras(max_devices: int = 2) -> List[int]:
    """Probe device ids by open/close."""
    k4a = _pyk4a()
    if k4a is None:
        return []
    found = []
    for device_id in range(max_devices):
        try:
            dev = k4a.PyK4A(device_id=device_id)
            dev.start()
            dev.stop()
            found.append(device_id)
        except Exception:
            break
    log_info(f"detected {len(found)} Azure Kinect device(s)")
    return found


def rig_serials(max_devices: int = 2) -> List[str]:
    """Serial numbers of the attached rig, in device-id order, to validate
    saved rig calibrations."""
    k4a = _pyk4a()
    serials = []
    if k4a is None:
        return serials
    for device_id in detect_cameras(max_devices):
        try:
            dev = k4a.PyK4A(device_id=device_id)
            dev.start()
            serials.append(getattr(dev, "serial", "") or "")
            dev.stop()
        except Exception:
            serials.append("")
    return serials


class K4ALiveSource(FrameSource):
    """Live frames as (transformed_depth_u16, rgb_u8) aligned to color."""

    def __init__(self, device_id: int = 0, color_resolution: str = "RES_720P",
                 depth_mode: str = "NFOV_UNBINNED", fps: str = "FPS_30"):
        k4a = _pyk4a()
        if k4a is None:
            raise RuntimeError(
                "pyk4a is not installed — use NpzReplaySource or SyntheticSource")
        config = None
        # the init ladder across pyk4a API variants
        for attempt in range(3):
            try:
                if attempt == 0:
                    config = k4a.Config(
                        color_resolution=getattr(k4a.ColorResolution, color_resolution),
                        depth_mode=getattr(k4a.DepthMode, depth_mode),
                        camera_fps=getattr(k4a.FPS, fps),
                        synchronized_images_only=True,
                    )
                elif attempt == 1:
                    config = k4a.Config(
                        color_resolution=getattr(k4a.ColorResolution, color_resolution),
                        depth_mode=getattr(k4a.DepthMode, depth_mode),
                        synchronized_images_only=True,
                    )
                else:
                    config = k4a.Config()
                self.device = k4a.PyK4A(config=config, device_id=device_id)
                self.device.start()
                break
            except Exception as e:
                log_warning(f"k4a init attempt {attempt} failed: {e}")
                if attempt == 2:
                    raise
        self.device_id = device_id
        self.serial = getattr(self.device, "serial", "") or ""
        # the modes the device started with (the ladder's last rung takes
        # pyk4a's defaults)
        self.color_size, self.depth_size = mode_sizes(
            getattr(config, "color_resolution", color_resolution),
            getattr(config, "depth_mode", depth_mode))
        self.calibration = self._probe_calibration()

    def _probe_calibration(self) -> CameraCalibration:
        """The device's calibration, or the nominal model with the
        width * 1.03 color fallback when the probe fails, each at the
        configured modes' sizes."""
        try:
            return calibration_from_matrices(self.device.calibration, self.color_size,
                                             self.depth_size, self.serial)
        except Exception:
            log_warning("calibration probe failed; using nominal k4a model "
                        "(fx = width * 1.03 fallback)")
            return fallback_calibration(self.color_size, self.depth_size, self.serial)

    def capture(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        cap = self.device.get_capture()
        if cap.color is None or cap.transformed_depth is None:
            return None
        color = np.asarray(cap.color)
        if color.ndim == 3 and color.shape[2] == 4:
            color = color[..., 2::-1]  # BGRA -> RGB
        return np.asarray(cap.transformed_depth), color

    def frames(self):
        while True:
            f = self.capture()
            if f is not None:
                yield f

    def stop(self) -> None:
        try:
            self.device.stop()
        except Exception:
            pass
