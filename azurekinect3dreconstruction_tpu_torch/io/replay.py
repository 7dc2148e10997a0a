"""Recorded-frame (.npz) record and replay (the counterpart of the JAX
package's ``io/replay.py``).

A frame log is a directory of ``frame_%06d.npz`` files, each
``np.savez(path, color=..., depth=...)`` of the raw sensor arrays (u16 depth
in native units, u8 RGB, or BGRA as a raw k4a capture gives it), plus an
optional ``calibration.json``. The format is the JAX package's, so a log
written by either package replays in the other. The offline bundle's log is
its checkpoint: finalize re-reads it to reintegrate at optimized poses.
"""

from __future__ import annotations

import os
import re
from typing import Iterator, List, Optional, Tuple

import numpy as np

from azurekinect3dreconstruction_tpu_torch.core.camera import CameraCalibration

_FRAME_RE = re.compile(r"frame_(\d+)\.npz$")


def load_frame(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(depth, RGB color) of one logged frame; BGRA becomes RGB, alpha dropped."""
    with np.load(path) as data:
        depth = np.asarray(data["depth"])
        color = np.asarray(data["color"])
    if color.ndim == 3 and color.shape[2] == 4:
        color = color[..., 2::-1]
    return depth, color


class FrameSource:
    """Interface: iterate (depth_u16, color_u8) raw frames + calibration."""

    calibration: Optional[CameraCalibration] = None

    def frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        raise NotImplementedError

    def __iter__(self):
        return self.frames()


class NpzReplaySource(FrameSource):
    """Replays a directory of frame_%06d.npz dumps (sorted by index)."""

    def __init__(self, directory: str, calibration: Optional[CameraCalibration] = None,
                 limit: Optional[int] = None):
        self.directory = directory
        self.calibration = calibration
        names: List[Tuple[int, str]] = []
        for f in os.listdir(directory):
            m = _FRAME_RE.search(f)
            if m:
                names.append((int(m.group(1)), f))
        names.sort()
        self.files = [os.path.join(directory, f) for _, f in names]
        if limit is not None:
            self.files = self.files[:limit]
        calib_path = os.path.join(directory, "calibration.json")
        if calibration is None and os.path.exists(calib_path):
            with open(calib_path) as fh:
                self.calibration = CameraCalibration.from_json(fh.read())

    def __len__(self) -> int:
        return len(self.files)

    def frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for path in self.files:
            yield load_frame(path)


class FrameRecorder:
    """Writes the npz frame log (+ optional calibration)."""

    def __init__(self, directory: str, calibration: Optional[CameraCalibration] = None):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.count = 0
        if calibration is not None:
            with open(os.path.join(directory, "calibration.json"), "w") as fh:
                fh.write(calibration.to_json())

    def write(self, depth: np.ndarray, color: np.ndarray, index: Optional[int] = None) -> str:
        i = self.count if index is None else index
        path = os.path.join(self.directory, f"frame_{i:06d}.npz")
        np.savez(path, color=np.asarray(color), depth=np.asarray(depth))
        self.count = max(self.count, i + 1)
        return path


class SyntheticSource(FrameSource):
    """Wraps :class:`..io.synthetic.SyntheticCamera` and a pose trajectory."""

    def __init__(self, camera, poses):
        self.camera = camera
        self.poses = list(poses)
        self.calibration = CameraCalibration(depth=camera.intrinsics, color=camera.intrinsics,
                                             serial="synthetic")

    def __len__(self):
        return len(self.poses)

    def frames(self):
        for T in self.poses:
            yield self.camera.capture(T)

    def frames_with_poses(self):
        for T in self.poses:
            d, c = self.camera.capture(T)
            yield d, c, T
