"""Camera models: pinhole intrinsics, the Brown-Conrady distortion of the
k4a calibration, a device's full calibration, and the per-pixel ray table.

``Intrinsics``, ``Distortion`` and ``CameraCalibration`` are frozen,
hashable dataclasses of plain numbers (copies of the JAX package's), so they
can key caches, be compared between packages, and share one JSON form.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.core.fmath import div


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    @property
    def matrix(self) -> np.ndarray:
        """The 3x3 pinhole matrix K (float64)."""
        return np.array([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]])

    def scaled(self, factor: float) -> "Intrinsics":
        """Intrinsics for an image resized by ``factor`` (pyramid levels).

        Uses the pixel-center convention: cx' = (cx + 0.5) * f - 0.5.
        """
        return Intrinsics(
            width=int(round(self.width * factor)),
            height=int(round(self.height * factor)),
            fx=self.fx * factor,
            fy=self.fy * factor,
            cx=(self.cx + 0.5) * factor - 0.5,
            cy=(self.cy + 0.5) * factor - 0.5,
        )

    @staticmethod
    def azure_kinect_depth_nfov() -> "Intrinsics":
        """Nominal NFOV_UNBINNED 640x576 depth intrinsics (typical factory cal)."""
        return Intrinsics(640, 576, 504.0, 504.2, 321.9, 333.1)

    @staticmethod
    def azure_kinect_color_720p() -> "Intrinsics":
        """Nominal Azure Kinect 1280x720 color intrinsics."""
        return Intrinsics(1280, 720, 605.286, 605.699, 637.134, 366.758)

    @staticmethod
    def primesense_default() -> "Intrinsics":
        """Open3D's PrimeSenseDefault 640x480 intrinsics."""
        return Intrinsics(640, 480, 525.0, 525.0, 319.5, 239.5)

    @staticmethod
    def fallback_from_size(width: int, height: int) -> "Intrinsics":
        """The last-resort guess when a camera reports no calibration:
        fx = fy = width * 1.03, the principal point at the image center."""
        f = width * 1.03
        return Intrinsics(width, height, f, f, width / 2.0, height / 2.0)


@dataclasses.dataclass(frozen=True)
class Distortion:
    """Brown-Conrady rational model, the k4a calibration parameterization:
    x' = x (1 + k1 r2 + k2 r4 + k3 r6) / (1 + k4 r2 + k5 r4 + k6 r6) + tangential.
    All zero is an ideal pinhole. The methods take tensors (or numpy arrays)
    of normalized camera coordinates."""

    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    k5: float = 0.0
    k6: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def is_zero(self) -> bool:
        return all(getattr(self, f.name) == 0.0 for f in dataclasses.fields(self))

    def _radial(self, r2):
        r4 = r2 * r2
        r6 = r4 * r2
        num = 1.0 + self.k1 * r2 + self.k2 * r4 + self.k3 * r6
        den = 1.0 + self.k4 * r2 + self.k5 * r4 + self.k6 * r6
        return num / den

    def distort(self, xn, yn):
        """Apply the distortion to normalized camera coordinates."""
        r2 = xn * xn + yn * yn
        radial = self._radial(r2)
        xd = xn * radial + 2.0 * self.p1 * xn * yn + self.p2 * (r2 + 2.0 * xn * xn)
        yd = yn * radial + self.p1 * (r2 + 2.0 * yn * yn) + 2.0 * self.p2 * xn * yn
        return xd, yd

    def undistort(self, xd, yd, iters: int = 8):
        """Invert the model by a fixed number of fixed-point iterations."""
        xn, yn = xd, yd
        for _ in range(iters):
            r2 = xn * xn + yn * yn
            radial = self._radial(r2)
            dx = 2.0 * self.p1 * xn * yn + self.p2 * (r2 + 2.0 * xn * xn)
            dy = self.p1 * (r2 + 2.0 * yn * yn) + 2.0 * self.p2 * xn * yn
            xn = (xd - dx) / radial
            yn = (yd - dy) / radial
        return xn, yn


@dataclasses.dataclass(frozen=True)
class CameraCalibration:
    """A device's depth and color cameras and their extrinsic.

    ``T_color_depth`` (4x4 row tuples) maps depth-camera coordinates into
    color-camera coordinates, the transform ``ops.depth_to_color`` uses to
    compute the k4a ``transformed_depth``."""

    depth: Intrinsics
    color: Intrinsics
    depth_distortion: Distortion = Distortion()
    color_distortion: Distortion = Distortion()
    T_color_depth: Optional[Tuple[Tuple[float, ...], ...]] = None
    serial: str = ""

    @property
    def color_from_depth(self) -> np.ndarray:
        if self.T_color_depth is None:
            return np.eye(4)
        return np.array(self.T_color_depth, dtype=np.float64)

    @staticmethod
    def azure_kinect_nominal(serial: str = "") -> "CameraCalibration":
        """Nominal intrinsics, no distortion, and the ~32 mm depth-to-color
        baseline as a pure translation."""
        T = np.eye(4)
        T[0, 3] = -0.032
        return CameraCalibration(depth=Intrinsics.azure_kinect_depth_nfov(),
                                 color=Intrinsics.azure_kinect_color_720p(),
                                 T_color_depth=tuple(map(tuple, T.tolist())), serial=serial)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "CameraCalibration":
        d = json.loads(s)
        T = d.get("T_color_depth")
        return CameraCalibration(
            depth=Intrinsics(**d["depth"]),
            color=Intrinsics(**d["color"]),
            depth_distortion=Distortion(**d.get("depth_distortion", {})),
            color_distortion=Distortion(**d.get("color_distortion", {})),
            T_color_depth=tuple(map(tuple, T)) if T else None,
            serial=d.get("serial", ""),
        )


def pixel_rays(intr: Intrinsics, device, distortion: Optional[Distortion] = None
               ) -> torch.Tensor:
    """The per-pixel unit-z ray table (H, W, 2) = (x/z, y/z), float32.

    With a distortion it is the undistortion table: each observed pixel maps
    to the normalized ray that produced it."""
    u = torch.arange(intr.width, dtype=torch.float32, device=device)
    v = torch.arange(intr.height, dtype=torch.float32, device=device)
    xd = div(u[None, :] - intr.cx, intr.fx).expand(intr.height, intr.width)
    yd = div(v[:, None] - intr.cy, intr.fy).expand(intr.height, intr.width)
    if distortion is not None and not distortion.is_zero():
        xd, yd = distortion.undistort(xd, yd)
    return torch.stack([xd, yd], dim=-1)
