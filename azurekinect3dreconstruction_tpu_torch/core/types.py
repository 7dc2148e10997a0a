"""Frame container and the raw-sensor decode shared by every entry point."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _f32(x) -> float:
    """A Python float holding exactly the float32 nearest ``x``: torch then
    multiplies and compares in f32 against the same constant the JAX
    package uses."""
    return float(np.float32(x))


def decode_raw_frame(depth_raw, color_raw, inv_scale, depth_min, depth_trunc):
    """Raw sensor arrays -> (depth m (H,W), color [0,1] (H,W,3), intensity (H,W)).

    ``depth_raw``: (H, W) uint16 (or any integer) tensor in native units;
    ``color_raw``: (H, W, 3) uint8 RGB, or float in [0, 1].

    Depth scales by a float32 reciprocal *multiply*, and the u8 luma is
    computed in exact integers and scaled once, so the result is bit-equal
    to the JAX package's decode."""
    if depth_raw.dtype == torch.uint16:
        # widen through the same-width signed view: every backend converts int16
        depth_raw = depth_raw.view(torch.int16).to(torch.int32) & 0xFFFF
    d = depth_raw.to(torch.float32) * _f32(inv_scale)
    d = torch.where((d > _f32(depth_min)) & (d < _f32(depth_trunc)), d, 0.0)
    c = color_raw.to(torch.float32)
    if color_raw.dtype == torch.uint8:
        c = c * _f32(1.0 / 255.0)
        ci = color_raw.to(torch.int32)
        luma = 299 * ci[..., 0] + 587 * ci[..., 1] + 114 * ci[..., 2]
        intensity = luma.to(torch.float32) * _f32(1.0 / 255000.0)
    else:
        intensity = 0.299 * c[..., 0] + 0.587 * c[..., 1] + 0.114 * c[..., 2]
    return d, torch.clamp(c, 0.0, 1.0), intensity


@dataclasses.dataclass
class RGBDFrame:
    """One registered RGB-D frame in the depth camera's geometry.

    depth: (H, W) float32 meters, 0 where invalid; color: (H, W, 3) float32
    in [0, 1]; intensity: (H, W) float32 grayscale (for odometry)."""

    depth: torch.Tensor
    color: torch.Tensor
    intensity: torch.Tensor

    @staticmethod
    def from_raw(depth_raw, color, depth_scale: float = 1000.0, depth_trunc: float = 3.0,
                 depth_min: float = 0.1) -> "RGBDFrame":
        """Build from raw sensor tensors: integer depth in native units + u8
        RGB (float color is clipped to [0, 1] before the luma)."""
        if color.dtype != torch.uint8:
            color = torch.clamp(color.to(torch.float32), 0.0, 1.0)
        return RGBDFrame(*decode_raw_frame(depth_raw, color, 1.0 / depth_scale,
                                           depth_min, depth_trunc))
