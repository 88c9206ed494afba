"""IBRNet (Wang et al., CVPR 2021): the ResUNet's coarse and fine feature
maps, a coarse and a fine aggregator, alpha compositing, and a fine level
at depths drawn from the coarse weights."""
from __future__ import annotations

import torch

from nerfbench.backbones import feature_dims, sampled_model
from nerfbench.counts import ibrnet as counts
from nerfbench.counts import resunet
from nerfbench.reference.ibrnet import IBRNet
from nerfbench.reference.render import composite, gather, two_levels
from nerfbench.reference.resunet import ResUNet

model = sampled_model


def modules(flags):
    cdim, fdim = feature_dims(flags)
    return {"feature_net": ResUNet(cdim, fdim, single_net=False),
            "net_coarse": IBRNet(cdim), "net_fine": IBRNet(fdim)}


def render_rays(model, rays_o, rays_d, camera, depth_range, feats, src_rgbs,
                src_cameras, given=None):
    """Both levels; with ``given``, the fine level also drawn from its
    coarse weights, as ``fine_given_coarse``."""
    def level(z, li):
        pts = z[..., None] * rays_d[:, None] + rays_o[:, None]
        rgb_feat, diff, mask = gather(pts, camera, src_rgbs,
                                      src_cameras.detach(), feats[li])
        raw = model["net_fine" if li else "net_coarse"](rgb_feat, diff, mask)
        return composite(raw, z, torch.sum(mask[..., 0], dim=0) > 1)

    weights = None if given is None else given["coarse"].get("weights")
    return two_levels(model, rays_d, depth_range, level, weights)


def frame_rgb(coarse):
    """The evaluator paints the rays the coarse level masks white."""
    return torch.where(coarse["mask"][:, None], coarse["rgb"],
                       torch.ones_like(coarse["rgb"]))


def feature_flops(flags, n_views, h, w):
    return resunet.forward_flops(n_views, h, w, sum(feature_dims(flags)))


def aggregator_flops(flags, n_views, rays, backward):
    s, i = int(flags["N_samples"]), int(flags.get("N_importance", 64))
    per = counts.per_ray(n_views, s, i)
    if backward:
        per += counts.backward_per_ray(n_views, s, i)
    return rays * per


def tiny(flags):
    return {"N_samples": 12, "N_importance": 8, "N_rand": 64,
            "chunk_size": 1024}
