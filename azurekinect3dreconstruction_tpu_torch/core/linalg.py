"""Tiny fixed-size linear algebra.

:func:`solve_spd6` is the 6x6 solve of every projective-ICP Gauss-Newton
step: an unrolled Cholesky on 0-d tensors, so the solve stays on the device
and never waits on the host (no ``torch.linalg`` info check).
"""

from __future__ import annotations

import torch


def solve_spd6(A, b):
    """Solve ``A x = b`` for a 6x6 symmetric positive-definite ``A`` by
    Cholesky, in the JAX package's operation order.

    Callers add a damping diagonal, which keeps ``A`` positive definite
    even when the system is rank-deficient; the ``1e-30`` floor under the
    square root only matters for an all-zero system, whose result the
    caller's finiteness gate rejects. Column ``j`` of the factor is formed
    as one vector op over rows ``j..5``; each sum subtracts its terms in
    index order, as the scalar form does."""
    L = torch.zeros((6, 6), dtype=A.dtype, device=A.device)
    for j in range(6):
        s = A[j:, j]
        for k in range(j):
            s = s - L[j:, k] * L[j, k]
        d = torch.sqrt(torch.clamp_min(s[0], 1e-30))
        L[j, j] = d
        L[j + 1:, j] = s[1:] / d
    y = b.clone()  # forward substitution: L y = b
    for k in range(6):
        y[k] = y[k] / L[k, k]
        y[k + 1:] = y[k + 1:] - L[k + 1:, k] * y[k]
    x = [None] * 6  # back substitution: L^T x = y
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k, i] * x[k]
        x[i] = s / L[i, i]
    return torch.stack(x)
