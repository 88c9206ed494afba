"""Plain ray rendering, frozen here as the benchmark's reference: what
the backbones (``nerfbench/backbones/``) build their renders from. Depths
spaced evenly in 1/z (or z), projection of every sample into every source
view, bilinear taps of colours and features (``grid_sample``,
align_corners, zeros outside), alpha compositing, and a fine level at
depths drawn from coarse weights by inverse-CDF sampling at evenly spaced
quantiles (and, given another's coarse weights, a second fine level drawn
from those).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rays_at(sel, camera):
    """Rays of pixels ``sel`` (row-major indices, (u, v) at integer
    coordinates) of a 34-float camera: (origins [N, 3], directions [N, 3])."""
    w = int(camera[1])
    k = camera[2:18].reshape(4, 4)[:3, :3]
    c2w = camera[18:34].reshape(4, 4)
    u = (sel % w).to(camera.dtype)
    v = torch.div(sel, w, rounding_mode="floor").to(camera.dtype)
    pix = torch.stack([u, v, torch.ones_like(u)], dim=0)
    d = (c2w[:3, :3] @ (torch.linalg.inv(k) @ pix)).T
    return c2w[:3, 3].expand_as(d), d


def coarse_depths(n_rays, near, far, n_samples, inv_uniform, like):
    steps = torch.arange(n_samples, dtype=like.dtype, device=like.device)
    if inv_uniform:
        z = 1.0 / (1.0 / near + steps * (1.0 / far - 1.0 / near)
                   / (n_samples - 1))
    else:
        z = near + steps * (far - near) / (n_samples - 1)
    return z[None].expand(n_rays, n_samples)


def inverse_cdf(bins, weights, n):
    """Depths at ``n`` evenly spaced quantiles of the piecewise-constant
    density ``weights`` (+1e-5) over ``bins`` [N, M+1]."""
    m = weights.shape[1]
    pdf = (weights + 1e-5) / torch.sum(weights + 1e-5, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]),
                     torch.cumsum(pdf, dim=-1)], dim=-1)
    u = (torch.arange(n, dtype=bins.dtype, device=bins.device)
         / (n - 1))[None].expand(bins.shape[0], n)
    above = torch.searchsorted(cdf[:, :m].contiguous(), u.contiguous(),
                               right=True)
    below = torch.clamp(above - 1, min=0)
    c0, c1 = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    b0, b1 = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
    den = torch.where(c1 - c0 < 1e-5, torch.ones_like(c0), c1 - c0)
    return b0 + (u - c0) / den * (b1 - b0)


def fine_depths(z, weights, n, inv_uniform):
    """The coarse depths and ``n`` importance depths, sorted."""
    w = weights[:, 1:-1]
    if inv_uniform:
        inv = 1.0 / z
        mid = 0.5 * (inv[:, 1:] + inv[:, :-1])
        extra = 1.0 / inverse_cdf(torch.flip(mid, [1]), torch.flip(w, [1]), n)
    else:
        extra = inverse_cdf(0.5 * (z[:, 1:] + z[:, :-1]), w, n)
    return torch.sort(torch.cat([z, extra], dim=-1), dim=-1).values


def gather(xyz, camera, src_rgbs, src_cameras, featmap):
    """Taps of the sample points ``xyz`` [R, S, 3] in every source view:
    (rgb and features [V, R, S, 3 + C], ray differences [V, R, S, 4],
    mask [V, R, S, 1])."""
    v = src_cameras.shape[0]
    h, w = src_cameras[0, 0], src_cameras[0, 1]
    lead = xyz.shape[:-1]
    pts = xyz.reshape(-1, 3)
    intr = src_cameras[:, 2:18].reshape(-1, 4, 4)
    c2w = src_cameras[:, 18:34].reshape(-1, 4, 4)
    homo = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=-1)
    proj = (intr @ torch.linalg.inv(c2w)) @ homo.T[None]  # [V, 4, P]
    px = torch.clamp(proj[:, 0] / torch.clamp(proj[:, 2], min=1e-8), -1e6, 1e6)
    py = torch.clamp(proj[:, 1] / torch.clamp(proj[:, 2], min=1e-8), -1e6, 1e6)
    grid = torch.stack([2.0 * px / (w - 1.0) - 1.0,
                        2.0 * py / (h - 1.0) - 1.0], dim=-1)[:, None]

    def taps(img):
        out = F.grid_sample(img.permute(0, 3, 1, 2), grid, mode="bilinear",
                            padding_mode="zeros", align_corners=True)
        return out[:, :, 0].transpose(1, 2)

    rgb_feat = torch.cat([taps(src_rgbs), taps(featmap)], dim=-1)
    to_query = camera[18:34].reshape(4, 4)[:3, 3] - pts
    to_query = to_query / (torch.linalg.norm(to_query, dim=-1,
                                             keepdim=True) + 1e-6)
    to_src = c2w[:, None, :3, 3] - pts[None]
    to_src = to_src / (torch.linalg.norm(to_src, dim=-1, keepdim=True) + 1e-6)
    diff = to_query[None] - to_src
    diff = diff / torch.clamp(torch.linalg.norm(diff, dim=-1, keepdim=True),
                              min=1e-6)
    dot = torch.sum(to_query[None] * to_src, dim=-1, keepdim=True)
    mask = ((px <= w - 1.0) & (px >= 0) & (py <= h - 1.0) & (py >= 0)
            & (proj[:, 2] > 0)).to(pts.dtype)
    shape = (v,) + lead
    return (rgb_feat.reshape(shape + (-1,)),
            torch.cat([diff, dot], dim=-1).reshape(shape + (4,)),
            mask.reshape(shape + (1,)))


def composite(raw, z, pixel_mask):
    """IBRNet's compositing: alpha = 1 - exp(-sigma), transmittance by
    cumulative product. :return: {'rgb', 'depth', 'weights', 'mask'}"""
    alpha = 1.0 - torch.exp(-raw[..., 3])
    t = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    t = torch.cat([torch.ones_like(t[:, :1]), t[:, :-1]], dim=-1)
    weights = alpha * t
    return {"rgb": torch.sum(weights[..., None] * raw[..., :3], dim=1),
            "depth": torch.sum(weights * z, dim=-1), "weights": weights,
            "mask": torch.sum(pixel_mask.to(raw.dtype), dim=1) > 8}


def two_levels(model, rays_d, depth_range, level, given_weights=None):
    """The coarse level at depths evenly spaced in 1/z (or z); where the
    model draws importance samples, the fine level at the coarse depths and
    as many more drawn from the coarse weights, and with ``given_weights``
    (another's coarse weights [R, S]) a second one drawn from those.

    :param model: {'n_samples', 'n_importance', 'inv_uniform', ...}
    :param level: ``level(z, i)``, the level at depths ``z`` [R, S'] through
        the coarse (``i`` 0) or the fine (1) net: a dict with 'weights'
    :return: {'coarse': {...}, 'fine': {...} or None[,
        'fine_given_coarse': {...}]}
    """
    near, far = depth_range.reshape(-1)[0], depth_range.reshape(-1)[1]
    z = coarse_depths(rays_d.shape[0], near, far, model["n_samples"],
                      model["inv_uniform"], rays_d)

    def fine(wts):
        return level(fine_depths(z, wts.detach(), model["n_importance"],
                                 model["inv_uniform"]), 1)

    coarse = level(z, 0)
    out = {"coarse": coarse, "fine": None}
    if model["n_importance"] > 0:
        out["fine"] = fine(coarse["weights"])
        if given_weights is not None:
            out["fine_given_coarse"] = fine(given_weights)
    return out
