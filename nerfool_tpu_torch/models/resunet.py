"""ResUNet feature extractor (port of ``nerfool_tpu/models/resunet.py``).

The reference's ResNet34-encoder U-Net: a 7x7/s2 reflect-padded stem, three
BasicBlock stages (3/4/6 blocks, stride 2 each, affine InstanceNorm), and a
two-stage bilinear(align_corners) + conv decoder with skip concats, ending in
a 1x1 conv that yields the coarse and fine channel groups at about 1/4 of the
input size. GNT's ``single_net`` variant has one head of ``coarse_out_ch``
channels that serves both levels. NCHW inside; NHWC at the boundary, as in
the JAX package.

``compute_dtype`` (e.g. ``torch.bfloat16``) is the dtype of the conv stack,
as in the JAX package: the input and every convolution's weight and bias are
cast to it explicitly (no autocast, which picks casts per op), the
InstanceNorm statistics stay float32, and the output is cast back to float32
so the gather tables, and the attack's backward scatter into them, keep full
precision. The parameters stay float32.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfool_tpu_torch.models.layers import (
    Conv2d,
    InstanceNorm,
    conv_reflect,
    upsample2_aligned,
)


def feature_hw(h, w):
    """Feature-map size for an h x w input: the 7x7/s2 stem and three
    stride-2 stages, then two x2 upsamplings (4x the last stage)."""
    def side(n):
        n = (n + 2 * 3 - 7) // 2 + 1
        for _ in range(3):
            n = (n + 2 - 3) // 2 + 1
        return 4 * n
    return side(h), side(w)


class BasicBlock(nn.Module):
    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = conv_reflect(inplanes, planes, 3, stride)
        self.bn1 = InstanceNorm(planes)
        self.conv2 = conv_reflect(planes, planes, 3, 1)
        self.bn2 = InstanceNorm(planes)
        self.downsample = (
            nn.Sequential(
                Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                InstanceNorm(planes),
            ) if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ConvBlock(nn.Module):
    """conv(reflect, bias) -> InstanceNorm -> ELU (the reference's ``conv``)."""

    def __init__(self, cin, cout, kernel_size=3):
        super().__init__()
        self.conv = conv_reflect(cin, cout, kernel_size, 1, bias=True)
        self.bn = InstanceNorm(cout)

    def forward(self, x):
        return F.elu(self.bn(self.conv(x)))


class UpConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvBlock(cin, cout, 3)

    def forward(self, x):
        return self.conv(upsample2_aligned(x))


def _skip_concat(up, enc):
    """Zero-pad ``enc`` spatially to ``up``'s size, concat [up, enc] on C."""
    dy = up.shape[2] - enc.shape[2]
    dx = up.shape[3] - enc.shape[3]
    enc = F.pad(enc, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    return torch.cat([up, enc], dim=1)


class ResUNet(nn.Module):
    def __init__(self, coarse_out_ch=32, fine_out_ch=32, coarse_only=False,
                 single_net=False, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.coarse_out_ch = coarse_out_ch
        self.fine_out_ch = fine_out_ch
        self.coarse_only = coarse_only
        self.single_net = single_net
        if single_net:
            out_ch = coarse_out_ch
        else:
            out_ch = coarse_out_ch + (0 if coarse_only else fine_out_ch)

        self.conv1 = conv_reflect(3, 64, 7, 2, padding=3)
        self.bn1 = InstanceNorm(64)
        self.layer1 = self._stage(64, 64, 3)
        self.layer2 = self._stage(64, 128, 4)
        self.layer3 = self._stage(128, 256, 6)
        self.upconv3 = UpConv(256, 128)
        self.iconv3 = ConvBlock(128 + 128, 128)
        self.upconv2 = UpConv(128, 64)
        self.iconv2 = ConvBlock(64 + 64, out_ch)
        self.out_conv = Conv2d(out_ch, out_ch, 1, 1)

    @staticmethod
    def _stage(inplanes, planes, blocks):
        layers = [BasicBlock(inplanes, planes, stride=2, downsample=True)]
        layers += [BasicBlock(planes, planes) for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def forward(self, x):
        """:param x: [V, H, W, 3] source images
        :return: (coarse [V, H/4, W/4, Cc], fine [V, H/4, W/4, Cf] or None);
            under ``single_net`` the one head twice, as the same tensor
        """
        dt = self.compute_dtype
        x = x.permute(0, 3, 1, 2)
        if dt is not None:
            x = x.to(dt)
        x = F.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)

        u = self.iconv3(_skip_concat(self.upconv3(x3), x2))
        u = self.iconv2(_skip_concat(self.upconv2(u), x1))
        out = self.out_conv(u).permute(0, 2, 3, 1)
        if dt is not None:
            out = out.float()
        if self.coarse_only:
            return out.contiguous(), None
        if self.single_net:
            out = out.contiguous()
            return out, out
        return (out[..., :self.coarse_out_ch].contiguous(),
                out[..., -self.fine_out_ch:].contiguous())
