"""Shared layers (port of ``nerfool_tpu/models/layers.py``), NCHW inside.

Parameter names follow the reference PyTorch modules, so reference
checkpoints load with ``load_state_dict``: ``nn.Conv2d``s (reflect padding
mode where the reference pads so) that compute in their input's dtype, an
affine InstanceNorm with ``weight``/``bias``, and MLPs laid out as
``nn.Sequential(Linear, act, Linear, ...)``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfool_tpu_torch.ops import conv2d
from nerfool_tpu_torch.utils import numerics


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` applied in its input's dtype: the float32 weight and
    bias are cast to it explicitly (a bf16 input runs a bf16 convolution,
    as flax's ``nn.Conv(dtype=...)`` does; the parameters stay float32).
    The padding is an ``F.pad`` of the input, then the convolution is valid:
    K5 (``ops/conv2d.py``) for float32 on a card, its plain version on the
    CPU, the library's for other dtypes (``conv2d.takes``)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        w = self.weight.to(x.dtype)
        if not conv2d.takes(x):
            return self._conv_forward(x, w, b)
        if self.dilation != (1, 1) or self.groups != 1 or (
                self.stride[0] != self.stride[1]):
            raise ValueError(f"conv2d takes dilation 1, one group and a "
                             f"square stride, not {self}")
        if any(self.padding):
            mode = ("constant" if self.padding_mode == "zeros"
                    else self.padding_mode)
            x = F.pad(x, self._reversed_padding_repeated_twice, mode=mode)
        return conv2d.convolution(x, w, b, self.stride[0])


def conv_reflect(cin, cout, kernel_size, stride=1, padding=None, bias=False):
    """2D conv with reflect padding (``nn.Conv2d(padding_mode='reflect')``),
    in its input's dtype."""
    pad = (kernel_size - 1) // 2 if padding is None else padding
    return Conv2d(cin, cout, kernel_size, stride=stride, padding=pad,
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
        # JAX's formula (two passes, a sqrt rounded to nearest): over maps of
        # a few pixels the normalisation amplifies every rounding difference
        c = x32 - x32.mean(dim=(2, 3), keepdim=True)
        var = (c * c).mean(dim=(2, 3), keepdim=True)
        y = c / numerics.sqrt(var + self.eps)
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
