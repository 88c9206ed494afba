"""GNT (Varma T et al., ICLR 2023): view transformers over the source
taps and ray transformers along the samples; the net's rgb and its
attention row as the compositing weights. ``single_net`` (the port's
default): one net and one feature map for every level."""
from __future__ import annotations

import torch

from nerfbench.backbones import feature_dims, sampled_model
from nerfbench.counts import gnt as counts
from nerfbench.counts import resunet
from nerfbench.reference.gnt import GNT
from nerfbench.reference.render import gather, two_levels
from nerfbench.reference.resunet import ResUNet

model = sampled_model


def single(flags):
    return str(flags.get("single_net", True)) == "True"


def modules(flags):
    cdim, fdim = feature_dims(flags)
    make = lambda c: GNT(c, int(flags["netwidth"]), int(flags["trans_depth"]))
    mods = {"feature_net": ResUNet(cdim, fdim, single_net=single(flags)),
            "net_coarse": make(cdim)}
    if not single(flags):
        mods["net_fine"] = make(fdim)
    return mods


def render_rays(model, rays_o, rays_d, camera, depth_range, feats, src_rgbs,
                src_cameras, given=None):
    """The coarse level; where ``N_importance`` > 0, a fine level too (and,
    with ``given``, one drawn from its coarse weights)."""
    def level(z, li):
        pts = z[..., None] * rays_d[:, None] + rays_o[:, None]
        rgb_feat, diff, mask = gather(pts, camera, src_rgbs,
                                      src_cameras.detach(), feats[li])
        out = model["net_fine" if li else "net_coarse"](rgb_feat, diff, mask,
                                                        pts, rays_d)
        wts = out[:, 3:]
        return {"rgb": out[:, :3], "weights": wts,
                "depth": torch.sum(wts * z, dim=-1)}

    weights = None if given is None else given["coarse"].get("weights")
    return two_levels(model, rays_d, depth_range, level, weights)


def frame_rgb(coarse):
    return coarse["rgb"]


def feature_flops(flags, n_views, h, w):
    cdim, fdim = feature_dims(flags)
    return resunet.forward_flops(n_views, h, w,
                                 cdim if single(flags) else cdim + fdim)


def aggregator_flops(flags, n_views, rays, backward):
    s, d, depth = (int(flags["N_samples"]), int(flags["netwidth"]),
                   int(flags["trans_depth"]))
    per = counts.per_ray(n_views, s, d, depth)
    if backward:
        per += counts.backward_per_ray(n_views, s, d, depth)
    return rays * per


def tiny(flags):
    return {"N_samples": 16, "trans_depth": 2, "N_rand": 64,
            "chunk_size": 512}
