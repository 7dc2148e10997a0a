"""Device selection: the port's counterpart of ``core/backend.py``.

There are exactly two devices. ``"cuda"`` runs the hand-written kernels and
``"cpu"`` runs their plain PyTorch versions; which one a wrapper takes is
decided by the device of the tensors it is given. There is no automatic
choice and no fallback: asking for CUDA without a card raises.
"""

from __future__ import annotations

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
