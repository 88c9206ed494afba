"""Depth sampling along rays (port of ``nerfool_tpu/render/sampling.py``).

Deterministic sampling (``det=True``, the evaluators') spaces coarse depths
evenly in z or in 1/z and takes fine depths from the inverse CDF at evenly
spaced quantiles. Stochastic sampling (``det=False``, training) jitters each
coarse depth uniformly between the midpoints of its neighbours and takes
fine depths at uniform quantiles. The uniform draws come from a
``torch.Generator`` or are handed in (``t_rand``, ``u``), so that a test can
feed the JAX package's draws.

pixelNeRF's sampler (its ``NeRFRenderer``, linear depth) draws at every
call, evaluation too: the coarse depths jittered in 64 equal strata
(``pixelnerf_coarse_depths``), fine depths at uniform quantiles of the
detached coarse weights, each jittered inside its coarse bin
(``pixelnerf_fine_depths``), and depths drawn around the coarse depth
(``pixelnerf_depth_samples``). Every draw is handed in.
"""
from __future__ import annotations

import torch


def _uniform(shape, like, generator, given):
    """``given`` (cast to ``like``'s dtype and device), else a U[0, 1) draw
    of ``generator``."""
    if given is not None:
        if tuple(given.shape) != tuple(shape):
            raise ValueError(f"draws of shape {tuple(given.shape)}, the "
                             f"sampler needs {tuple(shape)}")
        return given.to(like)
    return torch.rand(shape, dtype=like.dtype, device=like.device,
                      generator=generator)


def sample_along_camera_ray(ray_o, ray_d, depth_range, n_samples,
                            inv_uniform=False, det=True, generator=None,
                            t_rand=None):
    """Depths between near and far: evenly spaced, or jittered in their
    strata when ``det`` is False.

    :param ray_o, ray_d: [N, 3]
    :param depth_range: [1, 2] (near, far), both > 0
    :param inv_uniform: space the samples evenly in inverse depth
    :param generator: source of the jitter when ``det`` is False
    :param t_rand: [N, n_samples] U[0, 1) jitter used instead of the
        generator's
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
    if not det:
        mids = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        upper = torch.cat([mids, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], mids], dim=-1)
        t = _uniform(z_vals.shape, z_vals, generator, t_rand)
        z_vals = lower + (upper - lower) * t
    pts = z_vals[..., None] * ray_d[:, None, :] + ray_o[:, None, :]
    return pts, z_vals


def sample_pdf(bins, weights, n_samples, det=True, generator=None, u=None):
    """Inverse-CDF sampling at evenly spaced quantiles, or at uniform ones
    when ``det`` is False.

    :param bins: [N, M+1] bin edges (ascending)
    :param weights: [N, M] unnormalized bin weights
    :param generator: source of the quantiles when ``det`` is False
    :param u: [N, n_samples] U[0, 1) quantiles used instead of the
        generator's
    :return: [N, n_samples]
    """
    m = weights.shape[1]
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # [N, M+1]

    if det:
        # i / (n-1) in the working dtype: the quantiles jnp.linspace(0, 1,
        # n) yields bit for bit (torch.linspace rounds some of them
        # differently)
        u = torch.arange(n_samples, dtype=bins.dtype,
                         device=bins.device) / (n_samples - 1)
        u = u[None, :].expand(bins.shape[0], n_samples)
    else:
        u = _uniform((bins.shape[0], n_samples), bins, generator, u)

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
                      det=True, generator=None, u=None):
    """Coarse depths merged with importance samples, sorted ascending.

    Mid-point bins, edge weights dropped; with ``inv_uniform`` the bins live
    in 1/z (flipped so they ascend). ``det``, ``generator`` and ``u`` go to
    ``sample_pdf``.

    :return: z_all [N, n_samples + n_importance]
    """
    w = weights[:, 1:-1]
    if inv_uniform:
        inv_z = 1.0 / z_vals
        inv_mid = 0.5 * (inv_z[:, 1:] + inv_z[:, :-1])
        inv_samples = sample_pdf(torch.flip(inv_mid, dims=[1]),
                                 torch.flip(w, dims=[1]), n_importance,
                                 det=det, generator=generator, u=u)
        z_samples = 1.0 / inv_samples
    else:
        z_mid = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        z_samples = sample_pdf(z_mid, w, n_importance, det=det,
                               generator=generator, u=u)
    z_all = torch.cat([z_vals, z_samples], dim=-1)
    return torch.sort(z_all, dim=-1).values


def pixelnerf_coarse_depths(near, far, n_samples, u):
    """``n_samples`` strata of [near, far], each at a U[0, 1) offset ``u``
    [N, n_samples] inside it."""
    step = 1.0 / n_samples
    z = torch.linspace(0, 1 - step, n_samples, dtype=u.dtype, device=u.device)
    z = z[None] + u * step
    return near * (1 - z) + far * z


def pixelnerf_fine_depths(weights, near, far, u, u_bin):
    """Depths drawn from the coarse weights [N, M] (+1e-5, detached by the
    caller): the bin of quantile ``u`` [N, K] by its cdf, then ``u_bin``
    [N, K] of the way into that bin of M equal strata."""
    m = weights.shape[1]
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    inds = torch.searchsorted(cdf, u.contiguous(), right=True).to(u.dtype)
    inds = torch.clamp_min(inds - 1.0, 0.0)
    z = (inds + u_bin) / m
    return near * (1 - z) + far * z


def pixelnerf_depth_samples(depth, near, far, std, noise):
    """The depth [N] plus ``std`` times the standard normal ``noise`` [N,
    K], clamped to [near, far]; differentiable in ``depth``."""
    z = depth[:, None] + noise * std
    return torch.maximum(torch.minimum(z, far), near)
