"""Float32 arithmetic with the rounding of the JAX reference and the kernels.

Where a result decides a discrete choice (which pixel a voxel projects to,
which block a point falls in, whether a warped pixel is in bounds), one
rounding step makes a difference, so the port spells out how each
multiply-add and division rounds:

- :func:`fma` — ``a * b + c`` rounded once. XLA on the CPU contracts
  multiply-adds into fused ones, and the CUDA kernels use ``fmaf`` at the
  same places.
- :func:`dot3` — a 3-term sum of products, contracted the same way (a
  squared distance decides which neighbor is nearer).
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


def dot3(a, b):
    """Sum over the last axis (size 3) of ``a * b`` as XLA on the CPU
    compiles ``jnp.sum(a * b, axis=-1)``: ``fma(a2, b2, fma(a1, b1, a0 b0))``."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def f32_square(x: float) -> float:
    """``x * x`` as a float32 product of float32 ``x`` (a traced scalar
    squared in the JAX package), as a Python float."""
    x = np.float32(x)
    return float(x * x)


def rcp32(c: float) -> float:
    """The float32 reciprocal of float32 ``c``, as a Python float."""
    return float(np.float32(1.0) / np.float32(c))


def div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as an IEEE float32 division on the CPU and on CUDA."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)
