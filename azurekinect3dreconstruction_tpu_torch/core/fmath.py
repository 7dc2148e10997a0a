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
- :func:`exp32` — ``exp`` as XLA on the CPU compiles it (a Cephes
  polynomial), not a correctly rounded one.
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


_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
             1.6666665459e-1, 5.0000001201e-1)
_F32_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def exp32(x):
    """float32 ``exp`` as XLA's CPU backend compiles it: ``x = n ln2 + a``
    with ``n = floor(x log2(e) + 0.5)`` clamped to [-127, 127] (after ``x``
    to [-87.8, 88.8]), the Cephes polynomial for ``e^a`` in fused
    multiply-adds, and ``2^n`` built from the exponent bits (0 at n = -127).
    It differs from a correctly rounded exp by an ulp on ~10 % of inputs;
    the same steps give the same bits on any device."""
    x = torch.clamp(x.to(torch.float32), -87.8, 88.8)
    n = torch.clamp(torch.floor(fma(x, 1.44269504088896341, 0.5)), -127.0, 127.0)
    a = fma(n, 2.12194440e-4, fma(n, -0.693359375, x))  # x - n ln2 in two parts
    z = fma(a, _EXP_POLY[0], _EXP_POLY[1])
    for p in _EXP_POLY[2:]:
        z = fma(z, a, p)
    z = 1.0 + fma(z, a * a, a)
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = z * pow2
    return torch.where(out < _F32_MIN_NORMAL, 0.0, out)  # XLA flushes subnormals to zero


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
