"""pixelNeRF (Yu et al., CVPR 2021; ``sxyu/pixel-nerf``, ``conf/default_mv
.conf``), frozen here as the benchmark's reference in plain PyTorch: the
ResNet-34 encoder to ``layer3`` (BatchNorm, zero padding, the first max
pool), its four levels upsampled bilinearly (``align_corners``) to the
first one's size and concatenated; the latent indexed at each sample's
pixel in each source view (bilinear, ``align_corners``, border padding);
the point rotated into the source's frame under the positional encoding (6
frequencies from 1.5, the input included), the view direction rotated
alike; the ``ResnetFC`` (5 blocks of 512, ``lin_z`` in the first 3, the
views averaged before block 3); ``NeRFRenderer`` in linear depth: 64
jittered strata, a fine level at the coarse depths, 16 depths drawn from
the detached coarse weights and 16 around the (not detached) coarse depth,
sorted; compositing with the gaps between depths.

Parameter names are pixelNeRF's (``model.*`` of ``encoder``; ``lin_in``,
``lin_z.<i>``, ``blocks.<i>.fc_0`` / ``fc_1``, ``lin_out`` of each MLP).

Departures from pixelNeRF's code, each forced by the benchmark's rig or
cell:

- cameras are the rig's OpenCV ones (x right, y down, z forward) with their
  own intrinsics; pixelNeRF's are OpenGL's with the principal point at the
  image centre. The view-space inputs flip the signs of y and z; the
  pixels are the same;
- rays are the harness's (``reference.render.rays_at``): directions of unit
  camera depth, so depths and their gaps are z-depths between the rig's
  near and far; pixelNeRF's directions are unit vectors and its near and
  far distances along them. The direction fed to the MLP is normalised, as
  pixelNeRF's is;
- the sources in [0, 1] are mapped to [-1, 1] before the encoder, as
  pixelNeRF's loaders feed them; ``white_bkgd`` is off, as its
  ``conf/exp/dtu.conf`` sets for real scenes;
- the draws (the coarse jitter, the fine quantiles and their jitter in the
  bin, the depth noise) are handed in, not taken from ``torch.rand``;
- the PositionalEncoding's constants are computed in ``forward``, not held
  as buffers, and ``layer4`` and ``fc`` of torchvision's ResNet, which the
  encoder never runs, are not built.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# default_mv.conf: ResnetFC's widths and n_blocks / combine_layer, the
# positional encoding's num_freqs and freq_factor, the renderer's depth_std
D_IN, D_OUT, D_LATENT = 42, 4, 512
N_BLOCKS, COMBINE_LAYER = 5, 3
N_FREQS, FREQ_FACTOR = 6, 1.5
DEPTH_STD = 0.01


class Block(nn.Module):
    def __init__(self, inplanes, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                nn.BatchNorm2d(planes))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class ResNet34(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.layer1 = nn.Sequential(*[Block(64, 64) for _ in range(3)])
        self.layer2 = nn.Sequential(Block(64, 128, 2),
                                    *[Block(128, 128) for _ in range(3)])
        self.layer3 = nn.Sequential(Block(128, 256, 2),
                                    *[Block(256, 256) for _ in range(5)])


class Encoder(nn.Module):
    """``SpatialEncoder``: :return: (latent [V, 512, H/2, W/2], the same)"""

    def __init__(self):
        super().__init__()
        self.model = ResNet34()

    def forward(self, images):
        m = self.model
        x = images.permute(0, 3, 1, 2) * 2.0 - 1.0
        x = m.relu(m.bn1(m.conv1(x)))
        latents = [x]
        x = m.maxpool(x)
        for stage in (m.layer1, m.layer2, m.layer3):
            x = stage(x)
            latents.append(x)
        size = latents[0].shape[-2:]
        latent = torch.cat([F.interpolate(lv, size, mode="bilinear",
                                          align_corners=True)
                            for lv in latents], dim=1)
        return latent, latent


class ResnetBlockFC(nn.Module):
    def __init__(self, size):
        super().__init__()
        self.fc_0 = nn.Linear(size, size)
        self.fc_1 = nn.Linear(size, size)
        self.activation = nn.ReLU()

    def forward(self, x):
        net = self.fc_0(self.activation(x))
        dx = self.fc_1(self.activation(net))
        return x + dx


class ResnetFC(nn.Module):
    """:param latent: [V, ..., d_latent]; x: [V, ..., d_in]
    :return: [..., 4] (rgb logits, sigma before its ReLU)"""

    def __init__(self, d_hidden=512):
        super().__init__()
        self.lin_in = nn.Linear(D_IN, d_hidden)
        self.lin_out = nn.Linear(d_hidden, D_OUT)
        self.blocks = nn.ModuleList([ResnetBlockFC(d_hidden)
                                     for _ in range(N_BLOCKS)])
        self.lin_z = nn.ModuleList([nn.Linear(D_LATENT, d_hidden)
                                    for _ in range(COMBINE_LAYER)])
        self.activation = nn.ReLU()

    def forward(self, latent, x):
        x = self.lin_in(x)
        for blkid in range(N_BLOCKS):
            if blkid == COMBINE_LAYER:
                x = torch.mean(x, dim=0)  # combine_type average
            if blkid < COMBINE_LAYER:
                x = x + self.lin_z[blkid](latent)
            x = self.blocks[blkid](x)
        return self.lin_out(self.activation(x))


def encode(x):
    """``PositionalEncoding(include_input=True)`` of ``x [P, 3]``."""
    freqs = FREQ_FACTOR * 2.0 ** torch.arange(0, N_FREQS).to(x)
    freqs = torch.repeat_interleave(freqs, 2).view(1, -1, 1)
    phases = torch.zeros(2 * N_FREQS).to(x)
    phases[1::2] = math.pi * 0.5
    embed = x.unsqueeze(1).repeat(1, N_FREQS * 2, 1)
    embed = torch.sin(torch.addcmul(phases.view(1, -1, 1), embed, freqs))
    return torch.cat((x, embed.view(x.shape[0], -1)), dim=-1)


def mlp_inputs(pts, viewdirs, src_cameras, latent):
    """(latent taps [V, P, C], encoded inputs [V, P, d_in]) of the points
    ``pts [P, 3]`` with directions ``viewdirs [P, 3]`` (unit)."""
    v = src_cameras.shape[0]
    h, w = src_cameras[0, 0], src_cameras[0, 1]
    k = src_cameras[:, 2:18].reshape(v, 4, 4)
    c2w = src_cameras[:, 18:34].reshape(v, 4, 4)
    rot = c2w[:, :3, :3].transpose(1, 2)
    trans = -torch.bmm(rot, c2w[:, :3, 3:])
    xyz_rot = torch.matmul(rot[:, None], pts[None, ..., None])[..., 0]
    xyz = xyz_rot + trans[:, None, :, 0]
    focal = torch.stack([k[:, 0, 0], k[:, 1, 1]], dim=-1)
    c = torch.stack([k[:, 0, 2], k[:, 1, 2]], dim=-1)
    uv = xyz[..., :2] / xyz[..., 2:] * focal[:, None] + c[:, None]
    hl, wl = latent.shape[-2:]
    scaling = torch.tensor([wl / (wl - 1.0), hl / (hl - 1.0)]).to(pts) * 2.0
    uv = uv * (scaling / torch.stack([w, h])) - 1.0
    taps = F.grid_sample(latent, uv[:, :, None], align_corners=True,
                         mode="bilinear", padding_mode="border")[..., 0]
    dirs = torch.matmul(rot[:, None], viewdirs[None, ..., None])[..., 0]
    code = encode(xyz_rot.reshape(-1, 3))
    x = torch.cat([code, dirs.reshape(-1, 3)], dim=-1).reshape(v, -1,
                                                               code.shape[-1] + 3)
    return taps.transpose(1, 2), x


def composite(net, latent, rays_o, rays_d, z, near, far, src_cameras):
    """One level at depths ``z`` [R, K]: {'rgb', 'depth', 'weights'}."""
    r, kk = z.shape
    deltas = torch.cat([z[:, 1:] - z[:, :-1], far - z[:, -1:]], -1)
    pts = (rays_o[:, None] + z[..., None] * rays_d[:, None]).reshape(-1, 3)
    unit = rays_d / torch.norm(rays_d, dim=-1, keepdim=True)
    viewdirs = unit[:, None].expand(-1, kk, -1).reshape(-1, 3)
    taps, x = mlp_inputs(pts, viewdirs, src_cameras, latent)
    v = src_cameras.shape[0]
    out = net(taps.reshape(v, r, kk, -1), x.reshape(v, r, kk, -1))
    rgbs, sigmas = torch.sigmoid(out[..., :3]), torch.relu(out[..., 3])
    alphas = 1 - torch.exp(-deltas * torch.relu(sigmas))
    shifted = torch.cat([torch.ones_like(alphas[:, :1]),
                         1 - alphas + 1e-10], -1)
    weights = alphas * torch.cumprod(shifted, -1)[:, :-1]
    return {"rgb": torch.sum(weights.unsqueeze(-1) * rgbs, -2),
            "depth": torch.sum(weights * z, -1), "weights": weights}


def render(model, rays_o, rays_d, depth_range, latent, src_cameras, draws):
    """Both levels. ``draws``: (coarse U [R, Kc], fine U [R, Kf], bin U [R,
    Kf], depth N [R, Kd]).
    :return: {'coarse': {...}, 'fine': {...}}
    """
    near, far = depth_range.reshape(-1)[0], depth_range.reshape(-1)[1]
    u_c, u_f, u_b, noise = draws
    kc = model["n_samples"]
    level = lambda net, z: composite(
        model[net], latent, rays_o, rays_d, z, near, far, src_cameras)

    step = 1.0 / kc
    z_steps = torch.linspace(0, 1 - step, kc).to(rays_d)[None] + u_c * step
    z_coarse = near * (1 - z_steps) + far * z_steps
    coarse = level("net_coarse", z_coarse)

    weights = coarse["weights"].detach() + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    inds = torch.searchsorted(cdf, u_f, right=True).float() - 1.0
    inds = torch.clamp_min(inds, 0.0)
    z_steps = (inds + u_b) / kc
    z_fine = near * (1 - z_steps) + far * z_steps

    z_depth = coarse["depth"].unsqueeze(1).repeat((1, noise.shape[1]))
    z_depth = z_depth + noise * DEPTH_STD
    z_depth = torch.max(torch.min(z_depth, far), near)

    z_all = torch.sort(torch.cat([z_coarse, z_fine, z_depth], -1), -1)[0]
    return {"coarse": coarse, "fine": level("net_fine", z_all)}
