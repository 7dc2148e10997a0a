"""Azure Kinect MKV recording replay, a pyk4a-gated ``FrameSource`` (the
counterpart of the JAX package's ``io/mkv.py``).

MKV files are what ``k4arecorder`` produces; decoding their Matroska tracks
(MJPEG color, 16-bit depth and the calibration attachment) is the k4a SDK's
job, so this source delegates to ``pyk4a.PyK4APlayback`` as live capture
delegates to ``pyk4a.PyK4A``. Without pyk4a the constructor raises a
``RuntimeError`` that says so; the npz replay (``io.replay``) is the
hardware-free source. Frames are host numpy arrays.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from azurekinect3dreconstruction_tpu_torch.core.camera import (
    CameraCalibration,
    Intrinsics,
)
from azurekinect3dreconstruction_tpu_torch.io.replay import FrameSource
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info, log_warning


def is_available() -> bool:
    try:
        from pyk4a import PyK4APlayback  # noqa: F401

        return True
    except ImportError:
        return False


class MkvReplaySource(FrameSource):
    """Replays (depth_u16, color_u8 RGB) pairs from a k4arecorder .mkv.

    Yields depth->color-registered frames (``transformed_depth``-equivalent
    via the playback calibration), matching what the live adapter yields.
    """

    def __init__(self, path: str, limit: Optional[int] = None):
        if not is_available():
            raise RuntimeError(
                "pyk4a is not installed; MKV replay needs the k4a SDK. "
                "Use the npz replay backend (io.replay) for hardware-free runs.")
        from pyk4a import PyK4APlayback

        self.path = path
        self.limit = limit
        self._playback = PyK4APlayback(path)
        self._playback.open()
        self.calibration = self._calibration_from_playback()

    def _calibration_from_playback(self) -> Optional[CameraCalibration]:
        """Same probe-with-fallback pattern as io.k4a_live (the recording
        carries the device calibration as an attachment)."""
        try:
            cal = self._playback.calibration
            m = np.asarray(cal.get_camera_matrix(1))  # color camera
            color = Intrinsics(1280, 720, float(m[0, 0]), float(m[1, 1]),
                               float(m[0, 2]), float(m[1, 2]))
            md = np.asarray(cal.get_camera_matrix(0))  # depth camera
            depth = Intrinsics(640, 576, float(md[0, 0]), float(md[1, 1]),
                               float(md[0, 2]), float(md[1, 2]))
            return CameraCalibration(depth=depth, color=color, serial="mkv")
        except Exception as e:  # pragma: no cover - depends on file contents
            log_warning(f"MKV calibration unavailable ({e}); using defaults")
            return None

    def frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        from pyk4a import ImageFormat

        n = 0
        while self.limit is None or n < self.limit:
            try:
                capture = self._playback.get_next_capture()
            except EOFError:
                break
            if capture.color is None or capture.transformed_depth is None:
                continue
            color = capture.color
            if getattr(self._playback.configuration, "color_format", None) in (
                    getattr(ImageFormat, "COLOR_MJPG", None),):
                import cv2  # MJPEG tracks need a JPEG decoder

                color = cv2.imdecode(color, cv2.IMREAD_COLOR)
            if color.ndim == 3 and color.shape[2] == 4:
                color = color[..., 2::-1]  # BGRA -> RGB
            elif color.ndim == 3 and color.shape[2] == 3:
                color = color[..., ::-1]  # BGR -> RGB
            yield capture.transformed_depth, np.ascontiguousarray(color)
            n += 1
        log_info(f"MKV replay finished after {n} frames")

    def close(self):
        self._playback.close()
