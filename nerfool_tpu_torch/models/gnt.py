"""GNT aggregator (port of the plain path of ``nerfool_tpu/models/gnt.py``).

A stack of ``trans_depth`` blocks, each a view transformer (subtraction
attention over the source views, conditioned on ray-direction differences)
then a ray transformer (4-head self-attention along the samples), with the
NeRF embeddings of the sample points and view direction injected through
``q_fcs`` before every even block's ray transformer. With ``ret_alpha`` the
last ray attention's head-mean first-query row is returned as per-sample
compositing weights.

``fused_attn`` sends every ray attention through the hand-written kernel of
``ops/ray_attention.py`` (forward and backward) instead of materialising
the ``[R, H, S, S]`` map. ``fused_vt`` sends every view attention through the
kernel of ``ops/view_attention.py``, which streams the views and keeps every
``[V, R, S, .]`` intermediate out of device memory; it is forward only, for
no-grad renders.

Operands are views-first ``[V, R, S, C]``. Every product runs in the
operand dtype with the weights cast to it, as the JAX module does, so a
bf16 render rounds where the JAX package rounds. Parameter names follow the
reference's ``state_dict`` (``rgbfeat_fc.{0,2}``, ``view_crosstrans.{i}``,
``view_selftrans.{i}``, ``q_fcs.{i}`` for even i, ``norm``, ``rgb_fc``).
The TPU lane packings (sample-fold, ray-fold) are not ported: their flags
map to this path.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfool_tpu_torch.ops import view_attention as va


def nerf_embed(x, num_freqs=10, max_freq_log2=9):
    """NeRF sin/cos embedding with the input included, log-sampled bands,
    computed in ``x.dtype``.

    :param x: [..., D]
    :return: [..., D * (1 + 2 * num_freqs)] (band-major, sin before cos)
    """
    outs = [x]
    for e in torch.linspace(0.0, float(max_freq_log2), num_freqs).tolist():
        f = 2.0 ** e
        outs.append(torch.sin(x * f))
        outs.append(torch.cos(x * f))
    return torch.cat(outs, dim=-1)


def linear(x, layer):
    """``layer`` applied in ``x``'s dtype (weights cast to it)."""
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), b)


def layer_norm(x, norm):
    """``nn.LayerNorm`` applied in ``x``'s dtype."""
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), norm.eps)


class FeedForward(nn.Module):
    def __init__(self, dim, hid_dim):
        super().__init__()
        self.fc1 = nn.Linear(dim, hid_dim)
        self.fc2 = nn.Linear(hid_dim, dim)

    def forward(self, x):
        return linear(torch.relu(linear(x, self.fc1)), self.fc2)


def _mlp2(din, dh, dout):
    return nn.Sequential(nn.Linear(din, dh), nn.ReLU(), nn.Linear(dh, dout))


def mlp2(x, seq):
    """A ``Linear, ReLU, Linear`` sequence applied in ``x``'s dtype."""
    return linear(torch.relu(linear(x, seq[0])), seq[2])


class ViewAttention(nn.Module):
    """Subtraction attention over the source views.

    ``k_fc`` and ``v_fc`` chain with no nonlinearity between them, so one
    ``[D, 2D]`` product ``k @ [Wk | Wk @ Wv]`` gives both the keys and the
    values, as the JAX module computes it (``Wk @ Wv`` from the f32 weights,
    cast to the operands' dtype once).

    The module path is the plain version of the view-attention kernel
    (``ops/view_attention.view_attention_plain``, differentiable tensor
    ops). ``fused`` routes the forward through the kernel's wrapper
    instead (the CUDA kernel on the card), which is forward only and raises
    where autograd would need its gradient. float64 input keeps the module
    path.
    """

    def __init__(self, dim):
        super().__init__()
        self.q_fc = nn.Linear(dim, dim, bias=False)
        self.k_fc = nn.Linear(dim, dim, bias=False)
        self.v_fc = nn.Linear(dim, dim, bias=False)
        self.pos_fc = _mlp2(4, dim // 8, dim)
        self.attn_fc = _mlp2(dim, dim // 8, dim)
        self.out_fc = nn.Linear(dim, dim)

    def forward(self, q, k, pos, mask, fused=False):
        """:param q: [R, S, D]; k: [V, R, S, D]; pos: [V, R, S, 4];
        mask: [V, R, S, 1]
        :return: [R, S, D]
        """
        wk = self.k_fc.weight.t()
        weights = (self.q_fc.weight.t(),
                   torch.cat([wk, wk @ self.v_fc.weight.t()], dim=-1),
                   self.pos_fc[0].weight.t(), self.pos_fc[0].bias,
                   self.pos_fc[2].weight.t(), self.pos_fc[2].bias,
                   self.attn_fc[0].weight.t(), self.attn_fc[0].bias,
                   self.attn_fc[2].weight.t(), self.attn_fc[2].bias,
                   self.out_fc.weight.t(), self.out_fc.bias)
        if not fused or k.dtype == torch.float64:
            return va.view_attention_plain(q, k, pos, mask, *weights)
        v, r, s, d = k.shape
        out = va.view_attention(
            q.reshape(r * s, d), k.reshape(v, r * s, d),
            pos.reshape(v, r * s, pos.shape[-1]), mask.reshape(v, r * s, 1),
            *weights)
        return out.reshape(r, s, d)


class ViewTransformer(nn.Module):
    """Pre-LN view-transformer block."""

    def __init__(self, dim):
        super().__init__()
        self.attn_norm = nn.LayerNorm(dim, eps=1e-6)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim, 4 * dim)
        self.attn = ViewAttention(dim)

    def forward(self, q, k, pos, mask, fused=False):
        x = self.attn(layer_norm(q, self.attn_norm), k, pos, mask,
                      fused=fused) + q
        return self.ff(layer_norm(x, self.ff_norm)) + x


class RayAttention(nn.Module):
    """Multi-head self-attention along the sample axis; q, k and v come
    from one ``[D, 3D]`` product.

    ``fused`` routes it through the ray-attention kernel
    (``ops/ray_attention.py``: no ``[R, H, S, S]`` map, differentiable, a
    recomputing backward) and returns the head-mean first-query row
    ``[R, S]`` in place of the full map. float64 input keeps the module
    path."""

    def __init__(self, dim, n_heads=4):
        super().__init__()
        self.n_heads = n_heads
        self.q_fc = nn.Linear(dim, dim, bias=False)
        self.k_fc = nn.Linear(dim, dim, bias=False)
        self.v_fc = nn.Linear(dim, dim, bias=False)
        self.out_fc = nn.Linear(dim, dim)
        self._wqkv_kept = None

    def _wqkv(self):
        """The ``[D, 3D]`` q | k | v projection. Where no gradient reaches
        the weights, the same tensor while they keep their storage and
        version counter, so that the ray-attention kernel packs it once
        (``ops/ray_attention.py``)."""
        ws = (self.q_fc.weight, self.k_fc.weight, self.v_fc.weight)
        if torch.is_grad_enabled() and any(w.requires_grad for w in ws):
            return torch.cat(ws, dim=0).t()
        key = tuple((w.data_ptr(), w._version, w.dtype, w.device) for w in ws)
        if self._wqkv_kept is None or self._wqkv_kept[0] != key:
            # the detached weights keep their storage, so their addresses
            # in the key stay theirs while the entry lives
            with torch.inference_mode(False), torch.no_grad():
                self._wqkv_kept = (key, tuple(w.detach() for w in ws),
                                   torch.cat(ws, dim=0).t())
        return self._wqkv_kept[2]

    def forward(self, x, fused=False):
        """:param x: [R, S, D]
        :return: (out [R, S, D], attention [R, H, S, S]), or with ``fused``
            (out, first-query attention row averaged over heads [R, S])
        """
        r, s, d = x.shape
        nh = self.n_heads
        hd = d // nh
        wqkv = self._wqkv()
        if fused and x.dtype != torch.float64:
            from nerfool_tpu_torch.ops.ray_attention import ray_attention

            return ray_attention(x, wqkv, self.out_fc.weight.t(),
                                 self.out_fc.bias, nh)
        wqkv = wqkv.to(x.dtype)
        q, k, v = (x @ wqkv).reshape(r, s, 3, nh, hd).permute(2, 0, 3, 1, 4)
        attn = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(r, s, d)
        return linear(out, self.out_fc), attn


class RayTransformer(nn.Module):
    """Pre-LN ray-transformer block; also returns the head-mean attention
    row of the first query, [R, S]."""

    def __init__(self, dim, n_heads=4):
        super().__init__()
        self.attn_norm = nn.LayerNorm(dim, eps=1e-6)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim, 4 * dim)
        self.attn = RayAttention(dim, n_heads)

    def forward(self, x, fused_attn=False):
        fused = fused_attn and x.dtype != torch.float64
        y, attn = self.attn(layer_norm(x, self.attn_norm), fused=fused)
        x = y + x
        x = self.ff(layer_norm(x, self.ff_norm)) + x
        # the kernel already returns the [R, S] row mean
        return x, attn if fused else torch.mean(attn, dim=1)[:, 0]


class GNTAggregator(nn.Module):
    def __init__(self, in_feat_ch=32, netwidth=64, trans_depth=8,
                 posenc_freqs=10, ret_alpha=True):
        super().__init__()
        self.netwidth = netwidth
        self.trans_depth = trans_depth
        self.posenc_freqs = posenc_freqs
        self.ret_alpha = ret_alpha
        pe = 3 * (1 + 2 * posenc_freqs)
        self.rgbfeat_fc = _mlp2(in_feat_ch + 3, netwidth, netwidth)
        self.view_crosstrans = nn.ModuleList(
            ViewTransformer(netwidth) for _ in range(trans_depth))
        self.view_selftrans = nn.ModuleList(
            RayTransformer(netwidth) for _ in range(trans_depth))
        self.q_fcs = nn.ModuleList(
            _mlp2(netwidth + 2 * pe, netwidth, netwidth) if i % 2 == 0
            else nn.Identity() for i in range(trans_depth))
        self.norm = nn.LayerNorm(netwidth)  # eps 1e-5, unlike the blocks' 1e-6
        self.rgb_fc = nn.Linear(netwidth, 3)

    def embeddings(self, pts, ray_d):
        """NeRF embeddings of the points and the view directions, both
        [R, S, 63]. Under float64 they are computed in float32, as the
        reference hard-casts them, then promoted back."""
        emb_dt = torch.float32 if pts.dtype == torch.float64 else pts.dtype
        viewdirs = ray_d / torch.linalg.norm(ray_d, dim=-1, keepdim=True)
        views = nerf_embed(viewdirs.to(emb_dt), self.posenc_freqs)
        pts_emb = nerf_embed(pts.to(emb_dt), self.posenc_freqs).to(pts.dtype)
        views = views.to(pts.dtype)[:, None, :].expand(
            pts_emb.shape[:2] + (views.shape[-1],))
        return pts_emb, views

    def head(self, q, attn):
        """Final LayerNorm, mean over the samples, ``rgb_fc``:
        [R, 3], or [R, 3 + S] with the compositing weights under
        ``ret_alpha``."""
        rgb = linear(torch.mean(layer_norm(q, self.norm), dim=1), self.rgb_fc)
        return torch.cat([rgb, attn], dim=1) if self.ret_alpha else rgb

    def chain(self, rgb_feat, ray_diff, mask, pts_emb, views_emb,
              fused_attn=False, fused_vt=False):
        """The ``trans_depth`` blocks: what the chain kernel (``ops/chain.py``)
        computes, and its plain version (``fused_attn`` and ``fused_vt``
        off).

        :return: (q [R, S, D] before the final LayerNorm, attn0 [R, S] the
            last ray attention's head-mean first-query row)
        """
        x = mlp2(rgb_feat, self.rgbfeat_fc)
        q = torch.max(x, dim=0).values  # max-pool over views
        attn = None
        for i in range(self.trans_depth):
            q = self.view_crosstrans[i](q, x, ray_diff, mask, fused=fused_vt)
            if i % 2 == 0:  # replaces q, no residual
                q = mlp2(torch.cat([q, pts_emb, views_emb], dim=-1),
                         self.q_fcs[i])
            q, attn = self.view_selftrans[i](q, fused_attn=fused_attn)
        return q, attn

    def forward(self, rgb_feat, ray_diff, mask, pts, ray_d, fused_attn=False,
                fused_vt=False):
        """
        :param rgb_feat: [V, R, S, 3 + in_feat_ch]; ray_diff: [V, R, S, 4];
            mask: [V, R, S, 1]
        :param pts: [R, S, 3] sample points; ray_d: [R, 3]
        :param fused_attn: every ray attention through the fused kernel
            (``RenderConfig.gnt_fused_attn``)
        :param fused_vt: every view attention through the fused kernel,
            forward only (``RenderConfig.gnt_fused_vt``)
        :return: [R, 3], or [R, 3 + S] under ``ret_alpha``
        """
        pts_emb, views_emb = self.embeddings(pts, ray_d)
        return self.head(*self.chain(
            rgb_feat, ray_diff, mask, pts_emb, views_emb,
            fused_attn=fused_attn, fused_vt=fused_vt))
