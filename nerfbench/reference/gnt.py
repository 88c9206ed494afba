"""Plain GNT aggregator (Varma et al., ICLR 2023), frozen here as the
benchmark's reference: ``trans_depth`` blocks, each a pre-LN view
transformer (subtraction attention over the source views, per channel,
conditioned on the ray-direction differences) and a pre-LN 4-head ray
transformer along the samples, with the NeRF embeddings of the points and
view direction fed through ``q_fcs`` before every even block's ray
transformer. The last ray attention's head-mean first-query row is the
compositing weights. Operands are views-first ``[V, R, S, C]``.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn


def nerf_embed(x, n_freqs=10, max_log2=9):
    outs = [x]
    for e in torch.linspace(0.0, float(max_log2), n_freqs).tolist():
        outs += [torch.sin(x * 2.0 ** e), torch.cos(x * 2.0 ** e)]
    return torch.cat(outs, dim=-1)


def mlp2(din, dh, dout):
    return nn.Sequential(nn.Linear(din, dh), nn.ReLU(), nn.Linear(dh, dout))


class FeedForward(nn.Module):
    def __init__(self, dim, hid):
        super().__init__()
        self.fc1 = nn.Linear(dim, hid)
        self.fc2 = nn.Linear(hid, dim)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class ViewAttention(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.q_fc = nn.Linear(dim, dim, bias=False)
        self.k_fc = nn.Linear(dim, dim, bias=False)
        self.v_fc = nn.Linear(dim, dim, bias=False)
        self.pos_fc = mlp2(4, dim // 8, dim)
        self.attn_fc = mlp2(dim, dim // 8, dim)
        self.out_fc = nn.Linear(dim, dim)

    def forward(self, q, k, pos, mask):
        """q [R, S, D]; k [V, R, S, D]; pos [V, R, S, 4]; mask [V, R, S, 1]"""
        qp = self.q_fc(q)
        kp = self.k_fc(k)
        v = self.v_fc(kp)
        p = self.pos_fc(pos)
        a = self.attn_fc(kp - qp[None] + p)
        a = a.masked_fill(mask == 0, -1e9)
        w = torch.softmax(a, dim=0)
        return self.out_fc(torch.sum((v + p) * w, dim=0))


class ViewTransformer(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.attn_norm = nn.LayerNorm(dim, eps=1e-6)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim, 4 * dim)
        self.attn = ViewAttention(dim)

    def forward(self, q, k, pos, mask):
        x = self.attn(self.attn_norm(q), k, pos, mask) + q
        return self.ff(self.ff_norm(x)) + x


class RayAttention(nn.Module):
    def __init__(self, dim, n_heads=4):
        super().__init__()
        self.n_heads = n_heads
        self.q_fc = nn.Linear(dim, dim, bias=False)
        self.k_fc = nn.Linear(dim, dim, bias=False)
        self.v_fc = nn.Linear(dim, dim, bias=False)
        self.out_fc = nn.Linear(dim, dim)

    def forward(self, x):
        r, s, d = x.shape
        nh, hd = self.n_heads, d // self.n_heads
        heads = lambda t: t.reshape(r, s, nh, hd).transpose(1, 2)
        q, k, v = heads(self.q_fc(x)), heads(self.k_fc(x)), heads(self.v_fc(x))
        attn = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(r, s, d)
        return self.out_fc(out), attn


class RayTransformer(nn.Module):
    def __init__(self, dim, n_heads=4):
        super().__init__()
        self.attn_norm = nn.LayerNorm(dim, eps=1e-6)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim, 4 * dim)
        self.attn = RayAttention(dim, n_heads)

    def forward(self, x):
        y, attn = self.attn(self.attn_norm(x))
        x = y + x
        x = self.ff(self.ff_norm(x)) + x
        return x, torch.mean(attn, dim=1)[:, 0]


class GNT(nn.Module):
    def __init__(self, in_feat_ch=32, netwidth=64, trans_depth=8,
                 posenc_freqs=10):
        super().__init__()
        pe = 3 * (1 + 2 * posenc_freqs)
        self.posenc_freqs = posenc_freqs
        self.trans_depth = trans_depth
        self.rgbfeat_fc = mlp2(in_feat_ch + 3, netwidth, netwidth)
        self.view_crosstrans = nn.ModuleList(
            ViewTransformer(netwidth) for _ in range(trans_depth))
        self.view_selftrans = nn.ModuleList(
            RayTransformer(netwidth) for _ in range(trans_depth))
        self.q_fcs = nn.ModuleList(
            mlp2(netwidth + 2 * pe, netwidth, netwidth) if i % 2 == 0
            else nn.Identity() for i in range(trans_depth))
        self.norm = nn.LayerNorm(netwidth)
        self.rgb_fc = nn.Linear(netwidth, 3)

    def forward(self, rgb_feat, ray_diff, mask, pts, ray_d):
        """:return: [R, 3 + S]: rgb, then the compositing weights"""
        viewdirs = ray_d / torch.linalg.norm(ray_d, dim=-1, keepdim=True)
        pts_emb = nerf_embed(pts, self.posenc_freqs)
        views = nerf_embed(viewdirs, self.posenc_freqs)[:, None, :].expand(
            pts_emb.shape[:2] + (pts_emb.shape[-1],))
        x = self.rgbfeat_fc(rgb_feat)
        q = torch.max(x, dim=0).values
        attn = None
        for i in range(self.trans_depth):
            q = self.view_crosstrans[i](q, x, ray_diff, mask)
            if i % 2 == 0:
                q = self.q_fcs[i](torch.cat([q, pts_emb, views], dim=-1))
            q, attn = self.view_selftrans[i](q)
        rgb = self.rgb_fc(torch.mean(self.norm(q), dim=1))
        return torch.cat([rgb, attn], dim=1)
