"""Device resolution: the one place a device name becomes a ``torch.device``.

Entry points take an explicit device and thread it down; nothing below
picks a device on its own. Asking for ``cuda`` where no card is present is an
error, never a quiet move to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(name="cuda") -> torch.device:
    """:param name: ``"cuda"``, ``"cuda:N"``, ``"cpu"`` or a ``torch.device``
    :raises RuntimeError: when a CUDA device is asked for and none is available
    """
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
