"""Azure Kinect MKV recording replay, a pyk4a-gated ``FrameSource`` (the
counterpart of the JAX package's ``io/mkv.py``).

MKV files are what ``k4arecorder`` produces; decoding their Matroska tracks
(MJPEG color, 16-bit depth and the calibration attachment) is the k4a SDK's
job, so this source delegates to ``pyk4a.PyK4APlayback`` as live capture
delegates to ``pyk4a.PyK4A``. Without pyk4a the constructor raises a
``RuntimeError`` that says so; the npz replay (``io.replay``) is the
hardware-free source. Frames are host numpy arrays. The intrinsics carry
the recording's own sizes: its configuration's color resolution and depth
mode, else the first capture's images.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from azurekinect3dreconstruction_tpu_torch.core.camera import CameraCalibration
from azurekinect3dreconstruction_tpu_torch.io.k4a_live import (
    calibration_from_matrices,
    fallback_calibration,
    mode_name,
    mode_sizes,
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
        self._first = None  # a capture read ahead to size the frames, yielded first
        self.color_size, self.depth_size = self._recorded_sizes()
        self.calibration = self._calibration_from_playback()

    def _config(self, key: str):
        """A field of the recording's configuration (a dict in pyk4a; an
        attribute in some bindings), or None."""
        conf = getattr(self._playback, "configuration", None)
        return conf.get(key) if isinstance(conf, dict) else getattr(conf, key, None)

    def _recorded_sizes(self):
        """((color w, h), (depth w, h)) from the recording's configuration,
        else from the first capture that holds both images."""
        try:
            return mode_sizes(self._config("color_resolution"), self._config("depth_mode"))
        except ValueError:
            pass
        for capture in self._captures():
            color, depth = self._decoded(capture)
            if color is not None and capture.depth is not None:
                self._first = capture
                return (color.shape[1], color.shape[0]), (depth.shape[1], depth.shape[0])
        raise RuntimeError(f"{self.path}: no capture holds both a color and a depth image")

    def _calibration_from_playback(self) -> CameraCalibration:
        """Same probe-with-fallback pattern as io.k4a_live (the recording
        carries the device calibration as an attachment), at the
        recording's sizes."""
        try:
            return calibration_from_matrices(self._playback.calibration, self.color_size,
                                             self.depth_size, "mkv")
        except Exception as e:  # pragma: no cover - depends on file contents
            log_warning(f"MKV calibration unavailable ({e}); using the nominal model "
                        "(fx = width * 1.03 fallback)")
            return fallback_calibration(self.color_size, self.depth_size, "mkv")

    def _captures(self):
        """The read-ahead capture, then the recording's next ones to its end."""
        if self._first is not None:
            first, self._first = self._first, None
            yield first
        while True:
            try:
                yield self._playback.get_next_capture()
            except EOFError:
                return

    def _decoded(self, capture):
        """(color u8 RGB or None, the depth camera's image or None)."""
        color = capture.color
        if color is None:
            return None, capture.depth
        if mode_name(self._config("color_format")) == "COLOR_MJPG":
            import cv2  # MJPEG tracks need a JPEG decoder

            color = cv2.imdecode(color, cv2.IMREAD_COLOR)
        if color.ndim == 3 and color.shape[2] == 4:
            color = color[..., 2::-1]  # BGRA -> RGB
        elif color.ndim == 3 and color.shape[2] == 3:
            color = color[..., ::-1]  # BGR -> RGB
        return np.ascontiguousarray(color), capture.depth

    def frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = 0
        for capture in self._captures():
            if self.limit is not None and n >= self.limit:
                break
            if capture.color is None or capture.transformed_depth is None:
                continue
            yield capture.transformed_depth, self._decoded(capture)[0]
            n += 1
        log_info(f"MKV replay finished after {n} frames")

    def close(self):
        self._playback.close()
