"""IBRNet (``--backbone ibrnet``): the ResUNet and an ``IBRNetAggregator``
per level on the gathered pipeline; its [R, S, 4] raw output composited by
``raw2outputs``, ``geo_noise`` on sigma. Hybrids take raw colour or sigma
from the clean branch at both levels. In bf16 the parameters are cast on
each call (``functional_call``), as the JAX package casts its tree, so an
update needs no restack.
"""
from __future__ import annotations

import functools

import torch

from nerfool_tpu_torch.backbones import keep as checkpoint_state  # noqa: F401
from nerfool_tpu_torch.backbones import keep as render_config  # noqa: F401
from nerfool_tpu_torch.metrics.image import psnr, ssim  # noqa: F401
from nerfool_tpu_torch.models.ibrnet import IBRNetAggregator
from nerfool_tpu_torch.models.resunet import ResUNet
from nerfool_tpu_torch.render import gathered
from nerfool_tpu_torch.render.compositor import raw2outputs

LPIPS_NORMALIZE = True
LR_FLAG = "lrate_mlp"
PAINT_EMPTY_COARSE = True
PER_TAP = None
FLAGS = ()


def build(coarse_feat_dim, fine_feat_dim, anti_alias_pooling, coarse_only,
          feature_dtype, **_):
    agg = lambda dim: IBRNetAggregator(dim, anti_alias_pooling)
    return (ResUNet(coarse_feat_dim, fine_feat_dim, coarse_only, False,
                    compute_dtype=feature_dtype),
            agg(coarse_feat_dim), None if coarse_only else agg(fine_feat_dim))


def draw_shapes(cfg, n_rays):
    noise = None
    if cfg.geo_noise > 0:
        s, i = cfg.n_samples, cfg.n_importance
        noise = (((n_rays, s), "normal"),
                 ((n_rays, s + i), "normal") if i else None)
    return {"samples": gathered.sample_shapes(cfg, n_rays), "noise": noise}


def _aggregate(cfg, net, rgb_feat, ray_diff, mask, pts, ray_d, merged):
    if cfg.dtype != torch.float32:
        params = {k: p.to(cfg.dtype) for k, p in net.named_parameters()}
        return torch.func.functional_call(net, params,
                                          (rgb_feat, ray_diff, mask))
    return net(rgb_feat, ray_diff, mask)


def _finalize(cfg, raw, z_vals, pixel_mask, noise, clean):
    if clean is not None:
        raw = torch.cat([(clean if cfg.use_clean_color else raw)[..., :3],
                         (clean if cfg.use_clean_density else raw)[..., 3:4]],
                        dim=-1)
    return raw2outputs(raw, z_vals, pixel_mask, white_bkgd=cfg.white_bkgd,
                       geo_noise=cfg.geo_noise, noise=noise)


STEPS = gathered.Steps(_aggregate, _finalize, hybrid_levels=(0, 1))
render_rays = functools.partial(gathered.render_rays, STEPS)
