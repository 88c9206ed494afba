"""GNT (``--backbone gnt``): the ResUNet and a ``GNTAggregator`` per level
(``--single_net``: one for both) on the gathered pipeline; rgb [R, 3] and,
with ``--ret_alpha``, the last ray attention's weights as compositing
weights; no mask, no noise; the source cameras are not detached (pose
gradients flow). Hybrids take rgb or the weights from the clean branch at
the coarse level only and keep the attacked depth (the reference's quirks).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from nerfool_tpu_torch.backbones import keep as checkpoint_state  # noqa: F401
from nerfool_tpu_torch.config import on_off_auto
from nerfool_tpu_torch.metrics.image import img2psnr as psnr  # noqa: F401
from nerfool_tpu_torch.metrics.image import ssim_windowed as ssim  # noqa: F401
from nerfool_tpu_torch.models.gnt import GNTAggregator
from nerfool_tpu_torch.models.resunet import ResUNet
from nerfool_tpu_torch.render import gathered

LPIPS_NORMALIZE = False
LR_FLAG = "lrate_gnt"
PAINT_EMPTY_COARSE = False
PER_TAP = None
FLAGS = ("netwidth", "trans_depth", "single_net", "ret_alpha")


def build(coarse_feat_dim, fine_feat_dim, anti_alias_pooling, coarse_only,
          feature_dtype, netwidth, trans_depth, single_net, ret_alpha, **_):
    return (ResUNet(coarse_feat_dim, fine_feat_dim, coarse_only, single_net,
                    compute_dtype=feature_dtype),
            GNTAggregator(coarse_feat_dim, netwidth, trans_depth,
                          ret_alpha=ret_alpha),
            None if single_net else GNTAggregator(
                fine_feat_dim, netwidth, trans_depth, ret_alpha=True))


def render_config(cfg, args, use, device):
    """The view-attention kernel has no backward, so only frames take it."""
    cfg = dataclasses.replace(cfg, single_net=bool(args.single_net),
                              ret_alpha=bool(args.ret_alpha),
                              stop_camera_grad=False)
    attn = getattr(args, "gnt_fused_attn", "auto") == "on"
    if use == "frame":
        cuda = torch.device(device).type == "cuda"
        chain = getattr(args, "gnt_fused_chain", "auto")
        vt = on_off_auto(getattr(args, "gnt_fused_vt", "auto"))
        return dataclasses.replace(
            cfg, gnt_fused_attn=attn,
            gnt_fused_chain=chain == "on" or (chain == "auto" and cuda),
            gnt_fused_vt=vt == "on" or (vt == "auto" and cuda))
    if use == "attack":
        attn = bool(getattr(args, "gnt_fused_attack", False))
    if use in ("attack", "train"):
        return dataclasses.replace(cfg, gnt_fused_attn=attn)
    return cfg


def draw_shapes(cfg, n_rays):
    return {"samples": gathered.sample_shapes(cfg, n_rays), "noise": None}


def _chain(cfg, dtype):
    """Whether a level's taps of ``dtype`` go to the whole-chain kernel."""
    return cfg.gnt_fused_chain and dtype == torch.bfloat16


def _aggregate(cfg, net, rgb_feat, ray_diff, mask, pts, ray_d, merged):
    if _chain(cfg, rgb_feat.dtype):
        from nerfool_tpu_torch.ops.chain import fused_chain_aggregate

        return fused_chain_aggregate(net, rgb_feat, ray_diff, mask, pts,
                                     ray_d, merged)
    return net(rgb_feat, ray_diff, mask, pts, ray_d,
               fused_attn=cfg.gnt_fused_attn, fused_vt=cfg.gnt_fused_vt)


def _outputs(cfg, raw, z_vals):
    if not cfg.ret_alpha:
        return {"rgb": raw}
    weights = raw[:, 3:]
    return {"rgb": raw[:, :3], "weights": weights,
            "depth": torch.sum(weights * z_vals, dim=-1)}


def _finalize(cfg, raw, z_vals, pixel_mask, noise, clean):
    out = _outputs(cfg, raw, z_vals)
    if clean is not None:  # the attacked depth either way
        clean = _outputs(cfg, clean, z_vals)
        if cfg.use_clean_color:
            out["rgb"] = clean["rgb"]
        if cfg.use_clean_density:
            out["weights"] = clean["weights"]
    return out


STEPS = gathered.Steps(_aggregate, _finalize, hybrid_levels=(0,),
                       merged=_chain)
shade = functools.partial(gathered.shade, STEPS)
render_rays = functools.partial(gathered.render_rays, STEPS)
