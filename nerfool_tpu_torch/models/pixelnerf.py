"""pixelNeRF (Yu et al., CVPR 2021; ``sxyu/pixel-nerf`` ``src/model``): a
ResNet-34 image encoder whose feature maps, upsampled to its first level's
size and concatenated, are indexed at each sample's pixel in every source
view, and a per-view residual MLP (``ResnetFC``) whose views are averaged
after ``COMBINE_LAYER`` blocks. The widths, the encoding and the sampler's
depth std are ``conf/default_mv.conf``'s, fixed here as constants; only
the MLP's hidden width is a flag (``--pixelnerf_d_hidden``), which the CPU
tests cut.

Parameter names are pixelNeRF's, split by module as the port's bundle holds
them: the feature net is ``encoder`` (``model.conv1``, ``model.bn1``,
``model.layer<i>.<j>.conv1``, ... as torchvision names them), the
aggregators are ``mlp_coarse`` and ``mlp_fine`` (``lin_in``,
``lin_z.<i>``, ``blocks.<i>.fc_0``, ``blocks.<i>.fc_1``, ``lin_out``).
``split_checkpoint`` turns pixelNeRF's one flat state dict into the three.

The encoder's convolutions are ``models/layers.py``'s ``Conv2d`` (K5 for
float32 on a card), with zero padding; its BatchNorms use their running
statistics (the bundle keeps every module in eval mode, as for a frozen,
attacked net). The sources in [0, 1] are mapped to [-1, 1] first, as
pixelNeRF's loaders feed them. The latent map stays NCHW ``[V, 512, H/2,
W/2]``, as pixelNeRF indexes it with ``grid_sample``.

The MLP's inputs per sample and source view (``view_inputs``): the point
rotated into the source camera's frame (pixelNeRF's ``normalize_z``) under
the positional encoding ``[x, sin(f0 x), cos(f0 x), ..., cos(f5 x)]`` with
``f_k = 1.5 * 2^k`` (each cosine, as pixelNeRF computes it, the sine
a quarter turn on), then the unit view direction, rotated likewise. The
port's cameras are OpenCV's (x right, y down, z forward), not pixelNeRF's
OpenGL frame: the view-space inputs differ from its own by the signs of y
and z.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfool_tpu_torch.models.layers import Conv2d
from nerfool_tpu_torch.utils.profiling import span

# the stages of torchvision's ResNet-34 that the encoder runs (its
# ``num_layers`` 4): (planes, blocks, stride)
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2))
LATENT = 64 + sum(planes for planes, _, _ in STAGES)  # 512
# default_mv.conf: ResnetFC's n_blocks and combine_layer, the positional
# encoding's num_freqs and freq_factor, the renderer's depth_std
N_BLOCKS, COMBINE_LAYER = 5, 3
PE_FREQS, PE_FREQ_FACTOR = 6, 1.5
DEPTH_STD = 0.01
# the MLP's input width: the encoded point and the raw direction
D_IN = 3 + 6 * PE_FREQS + 3  # 42


class BasicBlock(nn.Module):
    """torchvision's ``BasicBlock``: two 3x3 convolutions (the first with
    the stride), BatchNorms, a 1x1 downsample where the shape changes."""

    def __init__(self, inplanes, planes, stride=1):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes, 1, stride, bias=False),
                nn.BatchNorm2d(planes))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetTrunk(nn.Module):
    """torchvision's ResNet-34 to ``layer3`` (``layer4`` and ``fc``, which
    the encoder never runs, are not built)."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for i, (planes, blocks, stride) in enumerate(STAGES):
            layers = [BasicBlock(inplanes, planes, stride)]
            layers += [BasicBlock(planes, planes) for _ in range(1, blocks)]
            self.add_module(f"layer{i + 1}", nn.Sequential(*layers))
            inplanes = planes


class SpatialEncoder(nn.Module):
    """pixelNeRF's ``SpatialEncoder`` (``backbone resnet34``, ``num_layers``
    4, ``use_first_pool``, bilinear upsampling with ``align_corners``)."""

    def __init__(self):
        super().__init__()
        self.model = ResNetTrunk()

    def forward(self, x):
        """:param x: [V, H, W, 3] in [0, 1]
        :return: (latent [V, 512, H/2, W/2], the same tensor): one map for
            both levels
        """
        m = self.model
        x = x.permute(0, 3, 1, 2) * 2.0 - 1.0
        x = F.relu(m.bn1(m.conv1(x)))
        latents = [x]
        x = m.maxpool(x)
        for stage in (m.layer1, m.layer2, m.layer3):
            x = stage(x)
            latents.append(x)
        with span("pixelnerf.latent"):
            size = latents[0].shape[-2:]
            # the first level is already at the latent's size (pixelNeRF
            # resamples it too, which returns it unchanged)
            latent = torch.cat([latents[0]] + [
                F.interpolate(lv, size, mode="bilinear", align_corners=True)
                for lv in latents[1:]], dim=1)
        return latent, latent


class ResnetBlockFC(nn.Module):
    """``x + fc_1(relu(fc_0(relu(x))))``."""

    def __init__(self, size):
        super().__init__()
        self.fc_0 = nn.Linear(size, size)
        self.fc_1 = nn.Linear(size, size)

    def forward(self, x):
        return x + self.fc_1(F.relu(self.fc_0(F.relu(x))))


class ResnetFC(nn.Module):
    """pixelNeRF's ``ResnetFC`` with ``combine_type average``: ``lin_in``;
    blocks ``0 .. COMBINE_LAYER - 1`` per source view, each after adding
    ``lin_z[b]`` of the latent; the mean over the views; the other blocks;
    ``lin_out`` after a ReLU. Returns the raw output (rgb logits, sigma
    before its ReLU)."""

    def __init__(self, d_hidden=512):
        super().__init__()
        self.lin_in = nn.Linear(D_IN, d_hidden)
        self.lin_out = nn.Linear(d_hidden, 4)
        self.blocks = nn.ModuleList(ResnetBlockFC(d_hidden)
                                    for _ in range(N_BLOCKS))
        self.lin_z = nn.ModuleList(nn.Linear(LATENT, d_hidden)
                                   for _ in range(COMBINE_LAYER))

    def forward(self, latent, x):
        """:param latent: [V, ..., 512] the latent taps
        :param x: [V, ..., D_IN] the encoded view-space inputs
        :return: [..., 4]
        """
        with span("pixelnerf.views"):
            h = self.lin_in(x)
            for b in range(COMBINE_LAYER):
                h = self.blocks[b](h + self.lin_z[b](latent))
        with span("pixelnerf.pooled"):
            h = torch.mean(h, dim=0)
            for blk in self.blocks[COMBINE_LAYER:]:
                h = blk(h)
            return self.lin_out(F.relu(h))


def positional_encoding(x):
    """pixelNeRF's ``PositionalEncoding`` (``include_input``) of ``x [...,
    3]``: ``[x, sin(f0 x), sin(f0 x + pi/2), sin(f1 x), ...]``."""
    freqs = PE_FREQ_FACTOR * 2.0 ** torch.arange(PE_FREQS, device=x.device,
                                                 dtype=x.dtype)
    freqs = torch.repeat_interleave(freqs, 2)
    phases = torch.zeros(2 * PE_FREQS, device=x.device, dtype=x.dtype)
    phases[1::2] = math.pi * 0.5
    embed = x.unsqueeze(-2).expand(*x.shape[:-1], 2 * PE_FREQS, 3)
    embed = torch.sin(torch.addcmul(phases[:, None], embed, freqs[:, None]))
    return torch.cat([x, embed.flatten(-2)], dim=-1)


def view_inputs(pts, ray_d, src_cameras):
    """The MLP's inputs of every sample in every source view.

    :param pts: [R, S, 3] sample points; ray_d: [R, 3]
    :param src_cameras: [V, 34]
    :return: [V, R, S, D_IN]
    """
    rot = src_cameras[:, 18:34].reshape(-1, 4, 4)[:, :3, :3].transpose(1, 2)
    xyz = torch.matmul(rot[:, None, None], pts[None, ..., None])[..., 0]
    dirs = ray_d / torch.linalg.vector_norm(ray_d, dim=-1, keepdim=True)
    dirs = torch.matmul(rot[:, None], dirs[None, ..., None])[..., 0]
    code = positional_encoding(xyz)
    return torch.cat([code, dirs[:, :, None].expand(-1, -1, pts.shape[1], -1)],
                     dim=-1)


def latent_taps(latent, pix_x, pix_y, h, w):
    """The latent map at the samples' pixels: pixel ``(x, y)`` of an
    ``h x w`` source is ``(x, y)`` times (latent size / image size) in the
    map, sampled bilinearly (``align_corners``, border padding).

    :param latent: [V, C, Hl, Wl]
    :param pix_x, pix_y: [V, P] pixel coordinates in the sources
    :return: [V, P, C]
    """
    hl, wl = latent.shape[-2:]
    gx = pix_x * (wl / (wl - 1) * 2.0 / w) - 1.0
    gy = pix_y * (hl / (hl - 1) * 2.0 / h) - 1.0
    grid = torch.stack([gx, gy], dim=-1)[:, None]
    out = F.grid_sample(latent, grid, mode="bilinear", padding_mode="border",
                        align_corners=True)
    return out[:, :, 0].transpose(1, 2)


def split_checkpoint(flat):
    """pixelNeRF's flat state dict (``encoder.*``, ``mlp_coarse.*``,
    ``mlp_fine.*``, ``code.*``) as the bundle's ``{'feature_net',
    'net_coarse', 'net_fine'}``: the encoder's unused stage
    (``model.layer4``) and the encoding's constant buffers are dropped."""
    out = {"feature_net": {}, "net_coarse": {}, "net_fine": {}}
    prefixes = {"encoder.": "feature_net", "mlp_coarse.": "net_coarse",
                "mlp_fine.": "net_fine"}
    for key, value in flat.items():
        for prefix, name in prefixes.items():
            if key.startswith(prefix):
                sub = key[len(prefix):]
                if not (name == "feature_net"
                        and sub.startswith("model.layer4.")):
                    out[name][sub] = value
    if not out["net_fine"]:
        out["net_fine"] = None
    return out
