"""IBRNet aggregator (port of the plain path of ``nerfool_tpu/models/ibrnet.py``).

Per-sample multi-view aggregation: a ray-direction MLP added to the gathered
features, anti-alias pooling weights, weighted mean/variance pooling,
visibility MLPs, a sinusoid-encoded 4-head self-attention along the ray, and
a per-view softmax color blend. Operands are views-first ``[V, R, S, C]``;
every pooling reduces over the leading axis.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from nerfool_tpu_torch.models.layers import MLP, TorchLayerNorm


def sinusoid_pos_encoding(n_samples: int, d_hid: int, dtype=torch.float32,
                          device=None):
    """Sinusoid table over the sample axis.

    The reference builds the table in float64 and hard-casts it to float32
    whatever the model dtype, so it is rounded through float32 here too.
    """
    position = np.arange(n_samples)[:, None]
    hid = np.arange(d_hid)[None, :]
    angle = position / np.power(10000.0, 2 * (hid // 2) / d_hid)
    table = np.zeros((n_samples, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.as_tensor(table.astype(np.float32), device=device).to(dtype)


def fused_mean_variance(x, weight, dim=0):
    """Weighted mean and (biased, around the weighted mean) variance.

    :param x: [V, R, S, F]; weight: [V, R, S, 1] summing to ~1 over V
    :return: (mean [1, R, S, F], var [1, R, S, F])
    """
    mean = torch.sum(x * weight, dim=dim, keepdim=True)
    var = torch.sum(weight * (x - mean) ** 2, dim=dim, keepdim=True)
    return mean, var


class MultiHeadAttention(nn.Module):
    """Post-LN multi-head self-attention along the sample axis."""

    def __init__(self, n_head, d_model, d_k, d_v):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.w_qs = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_ks = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_vs = nn.Linear(d_model, n_head * d_v, bias=False)
        self.fc = nn.Linear(n_head * d_v, d_model, bias=False)
        self.layer_norm = TorchLayerNorm(d_model)

    def forward(self, q, k, v, mask=None):
        b, lq = q.shape[0], q.shape[1]
        residual = q
        qh = self.w_qs(q).reshape(b, lq, self.n_head, self.d_k).transpose(1, 2)
        kh = self.w_ks(k).reshape(b, -1, self.n_head, self.d_k).transpose(1, 2)
        vh = self.w_vs(v).reshape(b, -1, self.n_head, self.d_v).transpose(1, 2)
        attn = (qh / (self.d_k ** 0.5)) @ kh.transpose(-1, -2)  # [B,H,Lq,Lk]
        if mask is not None:
            # mask [B, Lq, 1] -> [B, 1, Lq, 1]: a zero row masks a whole query
            attn = attn.masked_fill(mask[:, None] == 0, -1e9)
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ vh).transpose(1, 2).reshape(b, lq, -1)
        out = self.fc(out) + residual
        return self.layer_norm(out), attn


class IBRNetAggregator(nn.Module):
    def __init__(self, in_feat_ch=32, anti_alias_pooling=True):
        super().__init__()
        self.anti_alias_pooling = anti_alias_pooling
        c = in_feat_ch + 3
        self.ray_dir_fc = MLP(4, [16, c], final_act="elu")
        self.base_fc = MLP(3 * c, [64, 32], final_act="elu")
        self.vis_fc = MLP(32, [32, 33], final_act="elu")
        self.vis_fc2 = MLP(32, [32, 1], final_act="sigmoid")
        self.geometry_fc = MLP(32 * 2 + 1, [64, 16], final_act="elu")
        self.ray_attention = MultiHeadAttention(4, 16, 4, 4)
        self.out_geometry_fc = MLP(16, [16, 1], final_act="relu")
        self.rgb_fc = MLP(32 + 1 + 4, [16, 8, 1])
        if anti_alias_pooling:
            self.s = nn.Parameter(torch.tensor(0.2))

    def forward(self, rgb_feat, ray_diff, mask):
        """
        :param rgb_feat: [V, R, S, 3 + in_feat_ch] gathered colors + features
        :param ray_diff: [V, R, S, 4] direction difference (3) + dot (1)
        :param mask: [V, R, S, 1] float validity
        :return: raw [R, S, 4] (rgb, sigma)
        """
        num_views = rgb_feat.shape[0]
        direction_feat = self.ray_dir_fc(ray_diff)
        rgb_in = rgb_feat[..., :3]
        rgb_feat = rgb_feat + direction_feat

        if self.anti_alias_pooling:
            dot_prod = ray_diff[..., 3:4]
            exp_dot = torch.exp(torch.abs(self.s) * (dot_prod - 1))
            weight = (exp_dot - torch.min(exp_dot, dim=0, keepdim=True).values) * mask
            weight = weight / (torch.sum(weight, dim=0, keepdim=True) + 1e-8)
        else:
            weight = mask / (torch.sum(mask, dim=0, keepdim=True) + 1e-8)

        mean, var = fused_mean_variance(rgb_feat, weight)
        globalfeat = torch.cat([mean, var], dim=-1)  # [1, R, S, 2F]
        x = torch.cat([globalfeat.expand((num_views,) + globalfeat.shape[1:]),
                       rgb_feat], dim=-1)
        x = self.base_fc(x)

        x_vis = self.vis_fc(x * weight)
        x_res, vis = x_vis[..., :-1], x_vis[..., -1:]
        vis = torch.sigmoid(vis) * mask
        x = x + x_res
        vis = self.vis_fc2(x * vis) * mask
        weight = vis / (torch.sum(vis, dim=0, keepdim=True) + 1e-8)

        mean, var = fused_mean_variance(x, weight)
        globalfeat = torch.cat(
            [mean.squeeze(0), var.squeeze(0), torch.mean(weight, dim=0)], dim=-1
        )  # [R, S, 32*2+1]
        globalfeat = self.geometry_fc(globalfeat)
        num_valid_obs = torch.sum(mask, dim=0)  # [R, S, 1]
        globalfeat = globalfeat + sinusoid_pos_encoding(
            globalfeat.shape[1], 16, dtype=globalfeat.dtype,
            device=globalfeat.device)[None]
        attn_mask = (num_valid_obs > 1).to(globalfeat.dtype)
        globalfeat, _ = self.ray_attention(globalfeat, globalfeat, globalfeat,
                                           mask=attn_mask)
        sigma = self.out_geometry_fc(globalfeat)
        sigma_out = torch.where(num_valid_obs < 1, torch.zeros_like(sigma), sigma)

        x = torch.cat([x, vis, ray_diff], dim=-1)
        x = self.rgb_fc(x)
        x = torch.where(mask == 0, torch.full_like(x, -1e9), x)
        blending_weights = torch.softmax(x, dim=0)
        rgb_out = torch.sum(rgb_in * blending_weights, dim=0)  # [R, S, 3]
        return torch.cat([rgb_out, sigma_out], dim=-1)
