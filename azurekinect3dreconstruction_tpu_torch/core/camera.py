"""Pinhole intrinsics and the per-pixel ray table.

``Intrinsics`` is a frozen, hashable dataclass of plain numbers (a copy of
the JAX package's), so it can key caches and be compared between packages.
"""

from __future__ import annotations

import dataclasses

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


def pixel_rays(intr: Intrinsics, device) -> torch.Tensor:
    """The per-pixel unit-z ray table (H, W, 2) = (x/z, y/z), float32."""
    u = torch.arange(intr.width, dtype=torch.float32, device=device)
    v = torch.arange(intr.height, dtype=torch.float32, device=device)
    xd = div(u[None, :] - intr.cx, intr.fx).expand(intr.height, intr.width)
    yd = div(v[:, None] - intr.cy, intr.fy).expand(intr.height, intr.width)
    return torch.stack([xd, yd], dim=-1)
