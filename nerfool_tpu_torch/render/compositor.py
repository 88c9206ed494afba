"""Alpha compositing of per-sample radiance into per-ray outputs (port of
``nerfool_tpu/render/compositor.py``): distance-independent alpha
``1 - exp(-sigma)``, cumulative-product transmittance, and a ray mask that
needs more than 8 samples seen by at least two source views. ``geo_noise``
(a defense ablation) adds Gaussian noise of that standard deviation to sigma;
the caller passes the standard normal draw.
"""
from __future__ import annotations

import torch


def raw2outputs(raw, z_vals, pixel_mask, white_bkgd=False, geo_noise=0.0,
                noise=None):
    """
    :param raw: [N, S, 4] rgb + sigma from the aggregator
    :param z_vals: [N, S] sample depths (ascending)
    :param pixel_mask: [N, S] bool, sample has >= 2 valid source observations
    :param geo_noise: std of the noise added to sigma (0: none)
    :param noise: [N, S] standard normal draw, needed when geo_noise > 0
    :return: dict with rgb [N,3], depth [N], weights [N,S], mask [N] (bool),
        alpha [N,S], z_vals [N,S]
    """
    rgb = raw[:, :, :3]
    sigma = raw[:, :, 3]
    if geo_noise > 0:
        sigma = sigma + noise * geo_noise
    alpha = 1.0 - torch.exp(-sigma)
    t = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)[:, :-1]
    t = torch.cat([torch.ones_like(t[:, :1]), t], dim=-1)
    weights = alpha * t

    rgb_map = torch.sum(weights[..., None] * rgb, dim=1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - torch.sum(weights, dim=-1, keepdim=True))

    mask = torch.sum(pixel_mask.to(torch.float32), dim=1) > 8
    depth_map = torch.sum(weights * z_vals, dim=-1)
    return {
        "rgb": rgb_map,
        "depth": depth_map,
        "weights": weights,
        "mask": mask,
        "alpha": alpha,
        "z_vals": z_vals,
    }
