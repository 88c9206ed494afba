"""Plain IBRNet aggregator (Wang et al., CVPR 2021), frozen here as the
benchmark's reference: direction-conditioned features, anti-alias
weighted mean and variance pooling over the views, visibility MLPs, a
4-head self-attention along the ray, a per-view softmax colour blend.
Operands are views-first ``[V, R, S, C]``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn


def mlp(din, widths, final=None):
    layers = []
    for i, f in enumerate(widths):
        layers.append(nn.Linear(din, f))
        if i < len(widths) - 1:
            layers.append(nn.ELU())
        din = f
    if final is not None:
        layers.append(final())
    return nn.Sequential(*layers)


def sinusoid_table(n, d, device):
    pos = np.arange(n)[:, None]
    hid = np.arange(d)[None, :]
    angle = pos / np.power(10000.0, 2 * (hid // 2) / d)
    table = np.zeros((n, d))
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.as_tensor(table.astype(np.float32), device=device)


def weighted_mean_var(x, weight):
    mean = torch.sum(x * weight, dim=0, keepdim=True)
    var = torch.sum(weight * (x - mean) ** 2, dim=0, keepdim=True)
    return mean, var


class MultiHeadAttention(nn.Module):
    def __init__(self, n_head, d_model, d_k, d_v):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.w_qs = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_ks = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_vs = nn.Linear(d_model, n_head * d_v, bias=False)
        self.fc = nn.Linear(n_head * d_v, d_model, bias=False)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x, mask):
        b, n = x.shape[:2]
        q = self.w_qs(x).reshape(b, n, self.n_head, self.d_k).transpose(1, 2)
        k = self.w_ks(x).reshape(b, n, self.n_head, self.d_k).transpose(1, 2)
        v = self.w_vs(x).reshape(b, n, self.n_head, self.d_v).transpose(1, 2)
        attn = (q / self.d_k ** 0.5) @ k.transpose(-1, -2)
        attn = attn.masked_fill(mask[:, None] == 0, -1e9)
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, -1)
        return self.layer_norm(self.fc(out) + x)


class IBRNet(nn.Module):
    def __init__(self, in_feat_ch=32):
        super().__init__()
        c = in_feat_ch + 3
        self.ray_dir_fc = mlp(4, [16, c], nn.ELU)
        self.base_fc = mlp(3 * c, [64, 32], nn.ELU)
        self.vis_fc = mlp(32, [32, 33], nn.ELU)
        self.vis_fc2 = mlp(32, [32, 1], nn.Sigmoid)
        self.geometry_fc = mlp(65, [64, 16], nn.ELU)
        self.ray_attention = MultiHeadAttention(4, 16, 4, 4)
        self.out_geometry_fc = mlp(16, [16, 1], nn.ReLU)
        self.rgb_fc = mlp(37, [16, 8, 1])
        self.s = nn.Parameter(torch.tensor(0.2))

    def forward(self, rgb_feat, ray_diff, mask):
        """:return: [R, S, 4] rgb and sigma per sample"""
        n_views = rgb_feat.shape[0]
        rgb_in = rgb_feat[..., :3]
        rgb_feat = rgb_feat + self.ray_dir_fc(ray_diff)
        exp_dot = torch.exp(torch.abs(self.s) * (ray_diff[..., 3:4] - 1))
        weight = (exp_dot - torch.min(exp_dot, dim=0, keepdim=True).values) * mask
        weight = weight / (torch.sum(weight, dim=0, keepdim=True) + 1e-8)
        mean, var = weighted_mean_var(rgb_feat, weight)
        glob = torch.cat([mean, var], dim=-1)
        x = torch.cat([glob.expand((n_views,) + glob.shape[1:]), rgb_feat],
                      dim=-1)
        x = self.base_fc(x)
        x_vis = self.vis_fc(x * weight)
        x_res, vis = x_vis[..., :-1], x_vis[..., -1:]
        vis = torch.sigmoid(vis) * mask
        x = x + x_res
        vis = self.vis_fc2(x * vis) * mask
        weight = vis / (torch.sum(vis, dim=0, keepdim=True) + 1e-8)
        mean, var = weighted_mean_var(x, weight)
        glob = torch.cat([mean[0], var[0], torch.mean(weight, dim=0)], dim=-1)
        glob = self.geometry_fc(glob)
        n_valid = torch.sum(mask, dim=0)
        glob = glob + sinusoid_table(glob.shape[1], 16, glob.device)[None]
        glob = self.ray_attention(glob, (n_valid > 1).to(glob.dtype))
        sigma = self.out_geometry_fc(glob)
        sigma = torch.where(n_valid < 1, torch.zeros_like(sigma), sigma)
        x = self.rgb_fc(torch.cat([x, vis, ray_diff], dim=-1))
        x = torch.where(mask == 0, torch.full_like(x, -1e9), x)
        blend = torch.softmax(x, dim=0)
        return torch.cat([torch.sum(rgb_in * blend, dim=0), sigma], dim=-1)
