"""Device selection: the port's counterpart of ``core/backend.py``.

There are exactly two devices. ``"cuda"`` runs the hand-written kernels and
``"cpu"`` runs their plain PyTorch versions; which one a wrapper takes is
decided by the device of the tensors it is given. There is no automatic
choice and no fallback: asking for CUDA without a card raises.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``"cpu"`` / ``"cuda"`` / ``"cuda:N"`` / ``torch.device`` -> ``torch.device``.

    Raises ``ValueError`` for any other device type and ``RuntimeError`` for
    CUDA when no card is visible."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}: use 'cpu' or 'cuda'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
    return dev


@contextlib.contextmanager
def full_fp32_matmul():
    """Run float32 matrix products in full float32 inside the block, whatever
    the caller set: on CUDA, ``torch.set_float32_matmul_precision("high")``
    (or ``allow_tf32``) would otherwise round their inputs to TF32, about
    three decimal digits, which would move a pose by millimetres."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def upload(a, device: torch.device) -> torch.Tensor:
    """A host array (or tensor) -> a tensor on ``device`` without waiting
    on the device: to a card through a pinned staging copy and an
    asynchronous transfer. A tensor already on ``device`` is returned as is
    (``"cuda"`` names the current card, so a tensor on ``cuda:0`` is on it)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    if t.is_cuda or device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
