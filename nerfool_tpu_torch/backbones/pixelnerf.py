"""pixelNeRF (``--backbone pixelnerf``, ``models/pixelnerf.py``; no JAX
counterpart): its encoder and ``ResnetFC`` per level; a flat checkpoint is
split by module. float32, per tap, no hybrids. It samples as its
``NeRFRenderer`` does, at every call: jittered coarse strata, fine depths at
drawn quantiles of the detached coarse weights jittered in their bin, and
depths drawn around the coarse depth (not detached), all sorted. It gathers
the latent map alone and composites with the gaps between depths.
"""
from __future__ import annotations

import dataclasses

import torch

from nerfool_tpu_torch.metrics.image import psnr, ssim  # noqa: F401
from nerfool_tpu_torch.models import pixelnerf
from nerfool_tpu_torch.render.compositor import composite_deltas
from nerfool_tpu_torch.render.gathered import AGGREGATE, COMPOSITE, GATHER
from nerfool_tpu_torch.render.projection import project_points_planes
from nerfool_tpu_torch.render.sampling import weights_cdf
from nerfool_tpu_torch.utils.profiling import span

LPIPS_NORMALIZE = True
LR_FLAG = "lrate_mlp"
PAINT_EMPTY_COARSE = False
PER_TAP = "pixelNeRF gathers its latent map per tap"
FLAGS = ("pixelnerf_d_hidden",)


def build(coarse_feat_dim, fine_feat_dim, anti_alias_pooling, coarse_only,
          feature_dtype, pixelnerf_d_hidden, **_):
    if feature_dtype is not None:
        raise ValueError("pixelNeRF runs in float32")
    mlp = lambda: pixelnerf.ResnetFC(pixelnerf_d_hidden)
    return (pixelnerf.SpatialEncoder(), mlp(),
            None if coarse_only else mlp())


def checkpoint_state(blob):
    return blob if "feature_net" in blob else pixelnerf.split_checkpoint(blob)


def check(cfg):
    """Refuses what pixelNeRF does not render: bfloat16, hybrids, BSPG."""
    if cfg.bspg_specs is not None:
        raise ValueError("pixelNeRF renders per tap, without hybrids")
    if cfg.compute_dtype != "float32" or cfg.hybrid:
        raise ValueError("pixelNeRF renders in float32, without hybrids")


def render_config(cfg, args, use, device):
    cfg = dataclasses.replace(cfg, n_depth=getattr(args, "pixelnerf_n_depth",
                                                   16))
    check(cfg)
    return cfg


def draw_shapes(cfg, n_rays):
    s, i, d = cfg.n_samples, cfg.n_importance, cfg.n_depth
    return {"samples": (((n_rays, s), "uniform"), ((n_rays, i), "uniform"),
                        ((n_rays, i), "uniform"), ((n_rays, d), "normal")),
            "noise": None}


def coarse_depths(near, far, n_samples, u):
    """``n_samples`` strata of [near, far], each at a U[0, 1) offset ``u``
    [N, n_samples] inside it."""
    step = 1.0 / n_samples
    z = torch.linspace(0, 1 - step, n_samples, dtype=u.dtype, device=u.device)
    z = z[None] + u * step
    return near * (1 - z) + far * z


def fine_depths(weights, near, far, u, u_bin):
    """Depths drawn from the coarse weights [N, M] (+1e-5, detached by the
    caller): the bin of quantile ``u`` [N, K] by its cdf, then ``u_bin``
    [N, K] of the way into that bin of M equal strata."""
    cdf = weights_cdf(weights)
    inds = torch.searchsorted(cdf, u.contiguous(), right=True).to(u.dtype)
    inds = torch.clamp_min(inds - 1.0, 0.0)
    z = (inds + u_bin) / weights.shape[1]
    return near * (1 - z) + far * z


def depth_samples(depth, near, far, std, noise):
    """The depth [N] plus ``std`` times the standard normal ``noise`` [N,
    K], clamped to [near, far]; differentiable in ``depth``."""
    z = depth[:, None] + noise * std
    return torch.maximum(torch.minimum(z, far), near)


def render_rays(nets, ray_batch, featmaps, cfg, src_rgbs, src_cameras, draws,
                tables=None, featmaps_clean=None):
    """pixelNeRF's two levels over the latent map ``featmaps[level]``."""
    check(cfg)
    ray_o, ray_d = ray_batch["ray_o"], ray_batch["ray_d"]
    near, far = ray_batch["depth_range"].reshape(-1)[:2]
    u_coarse, u_fine, u_bin, noise = (x.to(ray_o) for x in draws["samples"])
    cams = src_cameras.detach() if cfg.stop_camera_grad else src_cameras
    v = cams.shape[0]
    h, w = cams[0, 0], cams[0, 1]

    def run_level(z, li):
        pts = z[..., None] * ray_d[:, None, :] + ray_o[:, None, :]
        with span(GATHER[li]):
            px, py, _ = project_points_planes(pts.reshape(-1, 3), cams)
            latent = pixelnerf.latent_taps(featmaps[li], px, py, h, w).reshape(
                (v,) + z.shape + (-1,))
            x_in = pixelnerf.view_inputs(pts, ray_d, cams)
        with span(AGGREGATE[li]):
            net = nets["net_coarse" if li == 0 else "net_fine"]
            raw = net(latent, x_in)
        with span(COMPOSITE[li]):
            return composite_deltas(torch.sigmoid(raw[..., :3]),
                                    torch.relu(raw[..., 3]), z, far,
                                    cfg.white_bkgd)

    z_coarse = coarse_depths(near, far, cfg.n_samples, u_coarse)
    coarse = run_level(z_coarse, 0)
    ret = {"outputs_coarse": coarse, "outputs_fine": None}
    if cfg.n_importance > 0 or cfg.n_depth > 0:
        with span("render.fine_sampler"):
            parts = [z_coarse]
            if cfg.n_importance > 0:
                parts.append(fine_depths(coarse["weights"].detach(), near,
                                         far, u_fine, u_bin))
            if cfg.n_depth > 0:
                parts.append(depth_samples(coarse["depth"], near, far,
                                           pixelnerf.DEPTH_STD, noise))
            z_fine = torch.sort(torch.cat(parts, dim=-1), dim=-1).values
        ret["outputs_fine"] = run_level(z_fine, 1)
    return ret
