"""Float32 arithmetic with the rounding of the JAX reference and the kernels.

Where a result decides a discrete choice (which pixel a voxel projects to,
which block a point falls in, whether a warped pixel is in bounds), one
rounding step makes a difference, so the port spells out how each
multiply-add and division rounds:

- :func:`fma` — ``a * b + c`` rounded once. XLA on the CPU contracts
  multiply-adds into fused ones, and the CUDA kernels use ``fmaf`` at the
  same places.
- :func:`rcp32` — XLA compiles ``x / c`` for a constant ``c`` into
  ``x * (1 / c)`` with the float32 reciprocal; the port multiplies by it.
- :func:`div` — a true division by a Python number on any device (PyTorch
  on CUDA divides a tensor by a Python number as a multiply by its
  reciprocal, and on the CPU as a division).
"""

from __future__ import annotations

import numpy as np
import torch


def _f64(x):
    return x.to(torch.float64) if isinstance(x, torch.Tensor) else float(np.float32(x))


def fma(a, b, c):
    """float32 ``a * b + c`` rounded once. Evaluated in float64, where the
    product of two floats is exact; Python numbers are first rounded to
    float32, as a float32 tensor op would."""
    return (_f64(a) * _f64(b) + _f64(c)).to(torch.float32)


def rcp32(c: float) -> float:
    """The float32 reciprocal of float32 ``c``, as a Python float."""
    return float(np.float32(1.0) / np.float32(c))


def div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as an IEEE float32 division on the CPU and on CUDA."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)
