"""Depth sampling along rays (port of ``nerfool_tpu/render/sampling.py``).

Deterministic sampling (``det=True``, the evaluators') spaces coarse depths
evenly in z or in 1/z and takes fine depths from the inverse CDF at evenly
spaced quantiles. Stochastic sampling (``det=False``, training) jitters each
coarse depth uniformly between the midpoints of its neighbours and takes
fine depths at uniform quantiles. The uniform draws are handed in
(``t_rand``, ``u``: ``render_rays.render_draws``' or, in a test, the JAX
package's). pixelNeRF's sampler is its backbone's
(``backbones/pixelnerf.py``).
"""
from __future__ import annotations

import torch


def _uniform(shape, like, given):
    """The U[0, 1) draws ``given``, cast to ``like``'s dtype and device."""
    got = None if given is None else tuple(given.shape)
    if got != tuple(shape):
        raise ValueError(f"draws of shape {got}, the sampler needs "
                         f"{tuple(shape)}")
    return given.to(like)


def sample_along_camera_ray(ray_o, ray_d, depth_range, n_samples,
                            inv_uniform=False, det=True, t_rand=None):
    """Depths between near and far: evenly spaced, or jittered in their
    strata when ``det`` is False.

    :param ray_o, ray_d: [N, 3]
    :param depth_range: [1, 2] (near, far), both > 0
    :param inv_uniform: space the samples evenly in inverse depth
    :param t_rand: [N, n_samples] U[0, 1) jitter, when ``det`` is False
    :return: (pts [N, n_samples, 3], z_vals [N, n_samples])
    """
    near, far = depth_range.reshape(-1)[:2]
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
    if not det:
        mids = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        upper = torch.cat([mids, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], mids], dim=-1)
        t = _uniform(z_vals.shape, z_vals, t_rand)
        z_vals = lower + (upper - lower) * t
    pts = z_vals[..., None] * ray_d[:, None, :] + ray_o[:, None, :]
    return pts, z_vals


def weights_cdf(weights):
    """The cdf [N, M + 1] (from 0) of the weights [N, M] + 1e-5."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    return torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)


def sample_pdf(bins, weights, n_samples, det=True, u=None):
    """Inverse-CDF sampling at evenly spaced quantiles, or at uniform ones
    when ``det`` is False.

    :param bins: [N, M+1] bin edges (ascending)
    :param weights: [N, M] unnormalized bin weights
    :param u: [N, n_samples] U[0, 1) quantiles, when ``det`` is False
    :return: [N, n_samples]
    """
    m = weights.shape[1]
    cdf = weights_cdf(weights)

    if det:
        # i / (n-1) in the working dtype: the quantiles jnp.linspace(0, 1,
        # n) yields bit for bit (torch.linspace rounds some of them
        # differently)
        u = torch.arange(n_samples, dtype=bins.dtype,
                         device=bins.device) / (n_samples - 1)
        u = u[None, :].expand(bins.shape[0], n_samples)
    else:
        u = _uniform((bins.shape[0], n_samples), bins, u)

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


def sample_fine_zvals(z_vals, weights, n_importance, inv_uniform=False,
                      det=True, u=None):
    """Coarse depths merged with importance samples, sorted ascending.

    Mid-point bins, edge weights dropped; with ``inv_uniform`` the bins live
    in 1/z (flipped so they ascend). ``det`` and ``u`` go to ``sample_pdf``.

    :return: z_all [N, n_samples + n_importance]
    """
    w = weights[:, 1:-1]
    if inv_uniform:
        inv_z = 1.0 / z_vals
        inv_mid = 0.5 * (inv_z[:, 1:] + inv_z[:, :-1])
        inv_samples = sample_pdf(torch.flip(inv_mid, dims=[1]),
                                 torch.flip(w, dims=[1]), n_importance,
                                 det=det, u=u)
        z_samples = 1.0 / inv_samples
    else:
        z_mid = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        z_samples = sample_pdf(z_mid, w, n_importance, det=det, u=u)
    z_all = torch.cat([z_vals, z_samples], dim=-1)
    return torch.sort(z_all, dim=-1).values

