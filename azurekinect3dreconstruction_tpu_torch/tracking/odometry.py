"""Hybrid photometric + geometric RGB-D odometry: result type and weights.

Convention (as in the JAX package): ``T_target_source`` takes source-camera
points into the target camera; the photometric term warps *source* pixels
into the *target* image. The Gauss-Newton loop itself is
``ops.kernels.odometry_kernels.compute_odometry_fast``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class OdometryResult(NamedTuple):
    T_target_source: torch.Tensor  # (4, 4)
    fitness: torch.Tensor  # inlier fraction of valid source pixels
    rmse: torch.Tensor  # final weighted residual RMS
    inliers: torch.Tensor  # int32 count


def huber_weight(r, delta: float):
    """IRLS Huber weight of a scaled residual: 1 inside ``delta``, else
    ``delta / |r|``."""
    a = torch.abs(r)
    d = torch.full((), delta, dtype=a.dtype, device=a.device)  # a true division on any device
    return torch.where(a <= delta, 1.0, d / torch.clamp_min(a, 1e-12))
