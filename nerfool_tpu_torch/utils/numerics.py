"""float32 elementwise functions rounded to nearest on every device."""
from __future__ import annotations

import torch


def sqrt(x):
    """``torch.sqrt``, rounded to nearest for float32. PyTorch's float32
    ``sqrt`` on the CPU is one unit in the last place off on some inputs
    in some builds (torch 2.13 on an AVX-512 host, against numpy, XLA and a
    float64 sqrt rounded to float32), where numpy's and XLA's are rounded to
    nearest; a float64 sqrt rounded to float32 gives the float32 result.
    CUDA's float32 sqrt is rounded to nearest already."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)
