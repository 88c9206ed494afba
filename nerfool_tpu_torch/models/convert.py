"""Flax parameter trees -> reference-layout PyTorch ``state_dict``s.

The inverse of ``nerfool_tpu/models/torch_port.py``: conv kernels HWIO ->
OIHW, dense kernels [in, out] -> [out, in], norm scale/bias -> weight/bias,
MLP ``fc{j}`` -> ``nn.Sequential`` index, GNT's ``view_trans_{i}`` /
``ray_trans_{i}`` / ``q_fc_{i}_{j}`` -> ``view_crosstrans`` /
``view_selftrans`` / ``q_fcs``. It takes plain numpy arrays (the
JAX bundle's ``params`` after ``np.asarray``), so this module needs no JAX;
the tests use it to run both packages on the same weights.
"""
from __future__ import annotations

import numpy as np
import torch


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv(p):
    return _t(np.asarray(p).transpose(3, 2, 0, 1))  # HWIO -> OIHW


def _dense(p):
    return _t(np.asarray(p).T)  # [in, out] -> [out, in]


def _norm(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _mlp(sd, prefix, p, torch_indices):
    for j, ti in enumerate(torch_indices):
        sd[f"{prefix}.{ti}.weight"] = _dense(p[f"fc{j}"]["kernel"])
        sd[f"{prefix}.{ti}.bias"] = _t(p[f"fc{j}"]["bias"])


def resunet_state_dict(p):
    """ResUNet flax params -> reference ``feature_net`` state_dict."""
    sd = {"conv1.weight": _conv(p["conv1"]["conv"]["kernel"])}
    _norm(sd, "bn1", p["bn1"])
    for layer, blocks in (("layer1", 3), ("layer2", 4), ("layer3", 6)):
        for i in range(blocks):
            blk = p[f"{layer}_{i}"]
            pre = f"{layer}.{i}"
            sd[f"{pre}.conv1.weight"] = _conv(blk["conv1"]["conv"]["kernel"])
            _norm(sd, f"{pre}.bn1", blk["bn1"])
            sd[f"{pre}.conv2.weight"] = _conv(blk["conv2"]["conv"]["kernel"])
            _norm(sd, f"{pre}.bn2", blk["bn2"])
            if "downsample_conv" in blk:
                sd[f"{pre}.downsample.0.weight"] = _conv(
                    blk["downsample_conv"]["kernel"])
                _norm(sd, f"{pre}.downsample.1", blk["downsample_norm"])
    for up in ("upconv3", "upconv2"):
        conv = p[up]["conv"]["conv"]
        sd[f"{up}.conv.conv.weight"] = _conv(conv["kernel"])
        sd[f"{up}.conv.conv.bias"] = _t(conv["bias"])
        _norm(sd, f"{up}.conv.bn", p[up]["bn"])
    for ic in ("iconv3", "iconv2"):
        conv = p[ic]["conv"]["conv"]
        sd[f"{ic}.conv.weight"] = _conv(conv["kernel"])
        sd[f"{ic}.conv.bias"] = _t(conv["bias"])
        _norm(sd, f"{ic}.bn", p[ic]["bn"])
    sd["out_conv.weight"] = _conv(p["out_conv"]["kernel"])
    sd["out_conv.bias"] = _t(p["out_conv"]["bias"])
    return sd


def ibrnet_state_dict(p):
    """IBRNetAggregator flax params -> reference ``net_coarse``/``net_fine``."""
    sd = {}
    for name in ("ray_dir_fc", "base_fc", "vis_fc", "vis_fc2", "geometry_fc",
                 "out_geometry_fc"):
        _mlp(sd, name, p[name], (0, 2))
    _mlp(sd, "rgb_fc", p["rgb_fc"], (0, 2, 4))
    ra = p["ray_attention"]
    for name in ("w_qs", "w_ks", "w_vs", "fc"):
        sd[f"ray_attention.{name}.weight"] = _dense(ra[name]["kernel"])
    _norm(sd, "ray_attention.layer_norm", ra["layer_norm"])
    if "s" in p:
        sd["s"] = _t(p["s"]).reshape(())
    return sd


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = _dense(p["kernel"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def gnt_state_dict(p):
    """GNTAggregator flax params -> reference ``net_coarse``/``net_fine``
    (the inverse of ``torch_port.gnt_params_from_torch``)."""
    sd = {}
    _linear(sd, "rgbfeat_fc.0", p["rgbfeat_fc0"])
    _linear(sd, "rgbfeat_fc.2", p["rgbfeat_fc1"])
    depth = sum(1 for k in p if k.startswith("view_trans_"))
    for i in range(depth):
        vt, rt = p[f"view_trans_{i}"], p[f"ray_trans_{i}"]
        for pre, blk in ((f"view_crosstrans.{i}", vt),
                         (f"view_selftrans.{i}", rt)):
            _norm(sd, f"{pre}.attn_norm", blk["attn_norm"])
            _norm(sd, f"{pre}.ff_norm", blk["ff_norm"])
            for fc in ("fc1", "fc2"):
                _linear(sd, f"{pre}.ff.{fc}", blk["ff"][fc])
            for fc in ("q_fc", "k_fc", "v_fc", "out_fc"):
                _linear(sd, f"{pre}.attn.{fc}", blk["attn"][fc])
        va = f"view_crosstrans.{i}.attn"
        for name, (a, b) in (("pos_fc", ("pos_fc0", "pos_fc1")),
                             ("attn_fc", ("attn_fc0", "attn_fc1"))):
            _linear(sd, f"{va}.{name}.0", vt["attn"][a])
            _linear(sd, f"{va}.{name}.2", vt["attn"][b])
        if i % 2 == 0:
            _linear(sd, f"q_fcs.{i}.0", p[f"q_fc_{i}_0"])
            _linear(sd, f"q_fcs.{i}.2", p[f"q_fc_{i}_1"])
    _norm(sd, "norm", p["norm"])
    _linear(sd, "rgb_fc", p["rgb_fc"])
    return sd


def params_from_flax(params_np):
    """The JAX bundle's ``params`` ({'feature_net', 'net_coarse'[,
    'net_fine']}, numpy leaves; IBRNet or GNT) -> the port's state_dicts
    under the same keys, in the reference checkpoint layout. A GNT bundle
    under ``single_net`` has no ``net_fine``."""
    agg = (gnt_state_dict if "rgbfeat_fc0" in params_np["net_coarse"]
           else ibrnet_state_dict)
    out = {
        "feature_net": resunet_state_dict(params_np["feature_net"]),
        "net_coarse": agg(params_np["net_coarse"]),
    }
    if "net_fine" in params_np:
        out["net_fine"] = agg(params_np["net_fine"])
    return out
