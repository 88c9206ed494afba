"""Shared layers (port of ``nerfool_tpu/models/layers.py``), NCHW inside.

Parameter names follow the reference PyTorch modules, so reference
checkpoints load with ``load_state_dict``: a plain ``nn.Conv2d`` in reflect
padding mode, an affine InstanceNorm with ``weight``/``bias``, and MLPs laid
out as ``nn.Sequential(Linear, act, Linear, ...)``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv_reflect(cin, cout, kernel_size, stride=1, padding=None, bias=False):
    """2D conv with reflect padding (``nn.Conv2d(padding_mode='reflect')``)."""
    pad = (kernel_size - 1) // 2 if padding is None else padding
    return nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=pad,
                     bias=bias, padding_mode="reflect")


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True, track_running_stats=False), eps 1e-5.

    Per-instance statistics are taken in at least float32 (a bf16 mean over
    ~2e5 pixels loses the signal); the result is cast back to the input dtype.
    """

    def __init__(self, channels, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):  # [N, C, H, W]
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = x32.mean(dim=(2, 3), keepdim=True)
        var = x32.var(dim=(2, 3), keepdim=True, unbiased=False)
        y = (x32 - mean) / torch.sqrt(var + self.eps)
        y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def upsample2_aligned(x):
    """Bilinear x2 upsample with align_corners=True. :param x: [N, C, H, W]"""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


_ACTS = {"elu": nn.ELU, "relu": nn.ReLU, "sigmoid": nn.Sigmoid}


class MLP(nn.Sequential):
    """``Linear(d0, d1), act, Linear(d1, d2), ...`` with an optional final
    activation: Linear layers sit at the even indices of the reference's
    ``nn.Sequential`` blocks."""

    def __init__(self, din: int, features: Sequence[int], act: str = "elu",
                 final_act: str | None = None):
        layers = []
        for i, f in enumerate(features):
            layers.append(nn.Linear(din, f))
            if i < len(features) - 1:
                layers.append(_ACTS[act]())
            din = f
        if final_act is not None:
            layers.append(_ACTS[final_act]())
        super().__init__(*layers)


def TorchLayerNorm(d, eps=1e-6):
    """LayerNorm with the reference's eps (``nn.LayerNorm(d, eps=1e-6)``)."""
    return nn.LayerNorm(d, eps=eps)
