"""Tiny fixed-size linear algebra.

:func:`solve_spd6` is the 6x6 solve of every projective-ICP Gauss-Newton
step: an unrolled Cholesky on 0-d tensors, so the solve stays on the device
and never waits on the host (no ``torch.linalg`` info check).
:func:`eigh_sym6` decomposes a symmetric 6x6 matrix the same way.
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


# the 15 index pairs of a 6x6 matrix in 5 rounds of 3 disjoint pairs (a
# round-robin tournament): one round's rotations commute
_JACOBI_ROUNDS = (((0, 5), (1, 4), (2, 3)), ((0, 4), (3, 5), (1, 2)), ((0, 3), (2, 4), (1, 5)),
                  ((0, 2), (1, 3), (4, 5)), ((0, 1), (2, 5), (3, 4)))


_JACOBI_INDEX = {}  # device -> the rounds' (P, Q) index tensors, made once outside any capture


def _jacobi_index(dev):
    if dev not in _JACOBI_INDEX:
        _JACOBI_INDEX[dev] = [tuple(torch.tensor(ix, device=dev) for ix in zip(*r))
                              for r in _JACOBI_ROUNDS]
    return _JACOBI_INDEX[dev]


def eigh_sym6(A, sweeps: int = 6):
    """Eigenvalues (unsorted) and eigenvectors (columns) of a symmetric 6x6
    ``A`` by parallel Jacobi rotations: each round zeroes 3 disjoint
    off-diagonal pairs at once with one orthogonal matrix, 5 rounds a sweep.
    A fixed number of sweeps (6 take a 6x6 to rounding) and no data-
    dependent branch, so it stays on the device, waits on nothing and can be
    captured in a CUDA graph, where ``torch.linalg.eigh`` checks its info
    on the host."""
    dev, dt = A.device, A.dtype
    eye = torch.eye(6, dtype=dt, device=dev)
    V = eye
    rounds = _jacobi_index(dev)
    for _ in range(sweeps):
        for P, Q in rounds:
            theta = 0.5 * torch.atan2(2.0 * A[P, Q], A[Q, Q] - A[P, P])
            c, s = torch.cos(theta), torch.sin(theta)
            G = eye.clone()
            G[P, P] = c
            G[Q, Q] = c
            G[P, Q] = s
            G[Q, P] = -s
            A = G.T @ A @ G
            V = V @ G
    return torch.diagonal(A), V
