"""Deterministic depth sampling along rays (port of
``nerfool_tpu/render/sampling.py``).

The evaluator forces deterministic sampling, so this slice has no random
numbers: coarse depths are evenly spaced in z or in 1/z, fine depths come from
the inverse CDF at evenly spaced quantiles.
"""
from __future__ import annotations

import torch


def sample_along_camera_ray(ray_o, ray_d, depth_range, n_samples,
                            inv_uniform=False):
    """Evenly spaced depths between near and far.

    :param ray_o, ray_d: [N, 3]
    :param depth_range: [1, 2] (near, far), both > 0
    :param inv_uniform: space the samples evenly in inverse depth
    :return: (pts [N, n_samples, 3], z_vals [N, n_samples])
    """
    near = depth_range.reshape(-1)[0]
    far = depth_range.reshape(-1)[1]
    n = ray_d.shape[0]
    steps = torch.arange(n_samples, dtype=ray_d.dtype, device=ray_d.device)
    if inv_uniform:
        start = 1.0 / near
        step = (1.0 / far - start) / (n_samples - 1)
        z_vals = 1.0 / (start + steps * step)
    else:
        step = (far - near) / (n_samples - 1)
        z_vals = near + steps * step
    z_vals = z_vals[None, :].expand(n, n_samples)
    pts = z_vals[..., None] * ray_d[:, None, :] + ray_o[:, None, :]
    return pts, z_vals


def sample_pdf(bins, weights, n_samples):
    """Inverse-CDF sampling at evenly spaced quantiles.

    :param bins: [N, M+1] bin edges (ascending)
    :param weights: [N, M] unnormalized bin weights
    :return: [N, n_samples]
    """
    m = weights.shape[1]
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # [N, M+1]

    # i / (n-1) in the working dtype: the quantiles jnp.linspace(0, 1, n)
    # yields bit for bit (torch.linspace rounds some of them differently)
    u = torch.arange(n_samples, dtype=bins.dtype,
                     device=bins.device) / (n_samples - 1)
    u = u[None, :].expand(bins.shape[0], n_samples)

    # rank of u among the first M cdf entries: above in [1, M]
    above = torch.sum((u[:, :, None] >= cdf[:, None, :m]).to(torch.int64),
                      dim=-1)
    below = torch.clamp(above - 1, min=0)

    cdf_below = torch.gather(cdf, 1, below)
    cdf_above = torch.gather(cdf, 1, above)
    bins_below = torch.gather(bins, 1, below)
    bins_above = torch.gather(bins, 1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def sample_fine_zvals(z_vals, weights, n_importance, inv_uniform=False):
    """Coarse depths merged with importance samples, sorted ascending.

    Mid-point bins, edge weights dropped; with ``inv_uniform`` the bins live
    in 1/z (flipped so they ascend).

    :return: z_all [N, n_samples + n_importance]
    """
    w = weights[:, 1:-1]
    if inv_uniform:
        inv_z = 1.0 / z_vals
        inv_mid = 0.5 * (inv_z[:, 1:] + inv_z[:, :-1])
        inv_samples = sample_pdf(torch.flip(inv_mid, dims=[1]),
                                 torch.flip(w, dims=[1]), n_importance)
        z_samples = 1.0 / inv_samples
    else:
        z_mid = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        z_samples = sample_pdf(z_mid, w, n_importance)
    z_all = torch.cat([z_vals, z_samples], dim=-1)
    return torch.sort(z_all, dim=-1).values
