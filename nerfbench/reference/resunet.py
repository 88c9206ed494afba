"""Plain ResUNet feature extractor: the published IBRNet / GNT feature
network (a ResNet34-style encoder with affine InstanceNorm, two bilinear
upsampling stages with skip concatenations, a 1x1 output conv), frozen here
as the benchmark's reference. NHWC at the boundary, NCHW inside. GNT's
``single_net`` has one head that serves both levels.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv(cin, cout, k, stride=1, padding=None, bias=False, reflect=True):
    pad = (k - 1) // 2 if padding is None else padding
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=bias,
                     padding_mode="reflect" if reflect else "zeros")


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True), eps 1e-5, biased variance."""

    def __init__(self, channels, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        c = x - x.mean(dim=(2, 3), keepdim=True)
        var = (c * c).mean(dim=(2, 3), keepdim=True)
        y = c / torch.sqrt(var + self.eps)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class BasicBlock(nn.Module):
    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride)
        self.bn1 = InstanceNorm(planes)
        self.conv2 = conv(planes, planes, 3, 1)
        self.bn2 = InstanceNorm(planes)
        self.downsample = (nn.Sequential(
            conv(inplanes, planes, 1, stride, padding=0, reflect=False),
            InstanceNorm(planes)) if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ConvBlock(nn.Module):
    def __init__(self, cin, cout, k=3):
        super().__init__()
        self.conv = conv(cin, cout, k, 1, bias=True)
        self.bn = InstanceNorm(cout)

    def forward(self, x):
        return F.elu(self.bn(self.conv(x)))


class UpConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvBlock(cin, cout, 3)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="bilinear",
                                       align_corners=True))


def skip_concat(up, enc):
    dy = up.shape[2] - enc.shape[2]
    dx = up.shape[3] - enc.shape[3]
    enc = F.pad(enc, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    return torch.cat([up, enc], dim=1)


class ResUNet(nn.Module):
    def __init__(self, coarse_out_ch=32, fine_out_ch=32, single_net=False):
        super().__init__()
        self.coarse_out_ch = coarse_out_ch
        self.fine_out_ch = fine_out_ch
        self.single_net = single_net
        out_ch = coarse_out_ch if single_net else coarse_out_ch + fine_out_ch
        self.conv1 = conv(3, 64, 7, 2, padding=3)
        self.bn1 = InstanceNorm(64)
        self.layer1 = self._stage(64, 64, 3)
        self.layer2 = self._stage(64, 128, 4)
        self.layer3 = self._stage(128, 256, 6)
        self.upconv3 = UpConv(256, 128)
        self.iconv3 = ConvBlock(256, 128)
        self.upconv2 = UpConv(128, 64)
        self.iconv2 = ConvBlock(128, out_ch)
        self.out_conv = nn.Conv2d(out_ch, out_ch, 1, 1)

    @staticmethod
    def _stage(inplanes, planes, blocks):
        return nn.Sequential(
            BasicBlock(inplanes, planes, stride=2, downsample=True),
            *(BasicBlock(planes, planes) for _ in range(1, blocks)))

    def forward(self, x):
        """:param x: [V, H, W, 3]
        :return: (coarse, fine) [V, H/4, W/4, C] each (the same tensor
            twice under ``single_net``)"""
        x = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        u = self.iconv3(skip_concat(self.upconv3(x3), x2))
        u = self.iconv2(skip_concat(self.upconv2(u), x1))
        out = self.out_conv(u).permute(0, 2, 3, 1)
        if self.single_net:
            out = out.contiguous()
            return out, out
        return (out[..., :self.coarse_out_ch].contiguous(),
                out[..., -self.fine_out_ch:].contiguous())
