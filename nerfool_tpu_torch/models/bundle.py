"""Model bundle (port of ``nerfool_tpu/models/bundle.py``): builds the IBRNet
or GNT modules, random-initializes them from a seeded ``torch.Generator`` or
loads reference-layout state_dicts, and runs the feature extraction.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import torch
import torch.nn as nn

from nerfool_tpu_torch.models.gnt import GNTAggregator
from nerfool_tpu_torch.models.ibrnet import IBRNetAggregator
from nerfool_tpu_torch.models.resunet import ResUNet


@dataclasses.dataclass
class ModelBundle:
    feature_net: ResUNet
    net_coarse: nn.Module
    net_fine: Optional[nn.Module]
    device: torch.device

    @property
    def nets(self):
        """{'net_coarse', 'net_fine'}; the fine net falls back to the coarse
        one in coarse-only and single_net setups."""
        return {"net_coarse": self.net_coarse,
                "net_fine": self.net_fine if self.net_fine is not None
                else self.net_coarse}

    def extract_features(self, src_rgbs):
        """:param src_rgbs: [V, H, W, 3] in [0, 1]
        :return: (coarse [V, Hf, Wf, C], fine [V, Hf, Wf, C])
        """
        coarse, fine = self.feature_net(src_rgbs)
        return coarse, (coarse if fine is None else fine)


def _seeded_init_(module: nn.Module, generator: torch.Generator):
    """PyTorch's default Linear/Conv init, U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    for weights and biases, drawn from ``generator``. Norm layers (GNT's
    LayerNorms included) keep ones/zeros and the anti-alias ``s`` its 0.2."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            with torch.no_grad():
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)


def create_model(args=None, backbone="ibrnet", coarse_feat_dim=32,
                 fine_feat_dim=32, anti_alias_pooling=True, coarse_only=False,
                 netwidth=64, trans_depth=8, single_net=False, ret_alpha=True,
                 ckpt_path=None, state_dicts=None, seed=0, device="cpu",
                 feature_dtype="float32") -> ModelBundle:
    """Build the IBRNet or GNT modules on ``device``.

    Weights come from, in order of precedence: ``state_dicts``
    ({'feature_net', 'net_coarse'[, 'net_fine']} in the reference key
    layout, e.g. from ``convert.params_from_flax``); a reference checkpoint
    at ``ckpt_path``; or a random init drawn on the CPU from
    ``torch.Generator().manual_seed(seed)``, so a seed gives the same weights
    on every device. ``feature_dtype`` ('float32' or 'bfloat16') is the
    feature net's compute dtype (its outputs are float32 either way).
    ``args`` (a parsed CLI namespace) supplies the same fields by their flag
    names.
    """
    if args is not None:
        backbone = getattr(args, "backbone", backbone)
        coarse_feat_dim = args.coarse_feat_dim
        fine_feat_dim = args.fine_feat_dim
        anti_alias_pooling = bool(args.anti_alias_pooling)
        coarse_only = args.coarse_only
        ckpt_path = args.ckpt_path or ckpt_path
        feature_dtype = getattr(args, "feature_dtype", feature_dtype)
        if backbone == "gnt":  # single_net is a GNT-stack concept
            netwidth = args.netwidth
            trans_depth = args.trans_depth
            single_net = bool(args.single_net)
            ret_alpha = bool(args.ret_alpha)
    if backbone not in ("ibrnet", "gnt"):
        raise ValueError(f"unknown backbone {backbone!r}")
    single_net = single_net and backbone == "gnt"
    if feature_dtype not in (None, "", "float32", "bfloat16"):
        raise ValueError(f"feature_dtype {feature_dtype!r} (float32 or "
                         "bfloat16)")
    feat_dt = torch.bfloat16 if feature_dtype == "bfloat16" else None

    with torch.random.fork_rng(devices=[]):  # module defaults draw globally
        feature_net = ResUNet(coarse_feat_dim, fine_feat_dim, coarse_only,
                              single_net, compute_dtype=feat_dt)
        if backbone == "ibrnet":
            net_coarse = IBRNetAggregator(coarse_feat_dim, anti_alias_pooling)
            net_fine = (None if coarse_only
                        else IBRNetAggregator(fine_feat_dim,
                                              anti_alias_pooling))
        else:
            net_coarse = GNTAggregator(coarse_feat_dim, netwidth, trans_depth,
                                       ret_alpha=ret_alpha)
            net_fine = (None if single_net
                        else GNTAggregator(fine_feat_dim, netwidth,
                                           trans_depth, ret_alpha=True))
    nets = {"feature_net": feature_net, "net_coarse": net_coarse,
            "net_fine": net_fine}

    if state_dicts is None and ckpt_path:
        if not os.path.exists(ckpt_path):
            raise FileNotFoundError(
                f"checkpoint {ckpt_path!r} not found; pass --ckpt_path '' "
                "for a seeded random init")
        state_dicts = torch.load(ckpt_path, map_location="cpu",
                                 weights_only=True)
    if state_dicts is not None:
        for name, module in nets.items():
            if module is not None:
                module.load_state_dict(state_dicts[name])
    else:
        gen = torch.Generator().manual_seed(int(seed))
        for module in nets.values():
            if module is not None:
                _seeded_init_(module, gen)

    dev = torch.device(device)
    for module in nets.values():
        if module is not None:
            module.to(dev).eval()
    return ModelBundle(feature_net, net_coarse, net_fine, dev)
