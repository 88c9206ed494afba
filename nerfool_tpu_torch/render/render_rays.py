"""Ray renderer (port of ``nerfool_tpu/render/render_rays.py``): the render
config, one render's random draws (``render_draws``, the one place they are
composed; a split's ranks draw a whole batch alike and keep their rows,
``share_draws``), and ``render_rays``, which hands the batch to its
backbone's module (``backbones/``): IBRNet and GNT on the gathered pipeline
(``render/gathered.py``), pixelNeRF on its own sampler and latent gather.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from nerfool_tpu_torch import backbones


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration."""

    n_samples: int = 64
    n_importance: int = 0
    inv_uniform: bool = False
    # deterministic sampling (the evaluators'); False jitters the coarse
    # depths and draws the fine quantiles (training)
    det: bool = True
    white_bkgd: bool = False
    backbone: str = "ibrnet"  # 'ibrnet' | 'gnt' | 'pixelnerf'
    single_net: bool = False  # gnt: net_coarse also renders the fine pass
    ret_alpha: bool = True  # gnt: return attention weights as density
    # detach the source cameras before projecting on the per-tap route: the
    # IBRNet stack does, the GNT stack does not (camera-pose attack
    # gradients flow through the projection)
    stop_camera_grad: bool = True
    # std of the noise on IBRNet's sigma (a defense ablation; 0: none)
    geo_noise: float = 0.0
    # hybrid renders: colour / density from the clean features' branch
    use_clean_color: bool = False
    use_clean_density: bool = False
    # aggregator dtype: 'float32' or 'bfloat16'
    compute_dtype: str = "float32"
    # gnt in bfloat16: run the aggregation through the whole-chain kernel
    # (ops/chain.py); f32 renders keep the module path
    gnt_fused_chain: bool = False
    # gnt: run every ray attention through the fused kernel
    # (ops/ray_attention.py), which is differentiable (a recomputing backward
    # kernel), so it serves no-grad renders and the attack step alike;
    # float64 inputs keep the module path
    gnt_fused_attn: bool = False
    # gnt: run every view attention through the fused kernel
    # (ops/view_attention.py). Forward only: for no-grad renders, never for
    # the attack step; float64 inputs keep the module path
    gnt_fused_vt: bool = False
    # (spec_feat, spec_rgb) BSPGSpec pair from the host planner: rays arrive
    # block-major and taps are rebuilt from per-(block, view) patch rows;
    # None keeps the per-tap gather
    bspg_specs: Optional[tuple] = None
    # pixelnerf: depths drawn around the coarse depth (their std is
    # models/pixelnerf.py's DEPTH_STD)
    n_depth: int = 16

    @property
    def hybrid(self):
        return self.use_clean_color or self.use_clean_density

    @property
    def dtype(self):
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.compute_dtype]


def render_draws(generator, cfg: RenderConfig, n_rays, dtype, device,
                 samples=None, noise=None):
    """One render's random draws for ``n_rays`` rays, {'samples',
    'noise'}: each a tuple of the draws the backbone's ``draw_shapes``
    names (an entry None where none is needed) or None. Drawn from
    ``generator``, the samples before the noise; a part given is kept."""
    shapes = backbones.of(cfg.backbone).draw_shapes(cfg, n_rays)

    def draw(part, given):
        if given is not None or shapes[part] is None:
            return given
        return tuple(None if s is None else (
            torch.rand if s[1] == "uniform" else torch.randn)(
                s[0], generator=generator, dtype=dtype, device=device)
            for s in shapes[part])

    return {"samples": draw("samples", samples), "noise": draw("noise", noise)}


def share_draws(generator, cfg: RenderConfig, sizes, rows, dtype, device,
                samples=None):
    """A split rank's share of the draws of consecutive renders of
    ``sizes`` rays: every rank draws them all, in the one-process order,
    and keeps each render's draws at its rays ``rows`` (end to end), or
    None. ``samples``: every render's sampling draws, given."""
    out, start = [], 0
    for n in sizes:
        d = render_draws(generator, cfg, n, dtype, device, samples=samples)
        lo, hi = max(rows.start - start, 0), min(rows.stop - start, n)
        out.append({k: None if v is None else tuple(
            None if x is None else x[lo:hi] for x in v)
            for k, v in d.items()} if lo < hi else None)
        start += n
    return out


def render_rays(nets, ray_batch, featmaps, cfg: RenderConfig, src_rgbs,
                src_cameras, tables=None, featmaps_clean=None, generator=None,
                noise=None, samples=None):
    """Render a batch of rays (coarse + optional fine pass).

    :param nets: {'net_coarse', 'net_fine'} aggregator modules
    :param ray_batch: ray_o [R,3], ray_d [R,3], depth_range [1,2], camera
        [1,34]; block-major rays when cfg.bspg_specs is set
    :param featmaps: (coarse, fine) each [V, Hf, Wf, C]
    :param src_rgbs: [V, H, W, 3]; src_cameras: [V, 34]
    :param tables: BSPG patch tables (``gathered.make_bspg_tables``; built
        when None and the config asks for BSPG)
    :param featmaps_clean: the clean sources' (coarse, fine) features, for
        hybrid renders (which take the per-tap gather)
    :param generator: the ``torch.Generator`` of the draws not handed in
    :param noise, samples: ``render_draws``' parts, handed in
    :return: {'outputs_coarse': {...}, 'outputs_fine': {...} | None}
    """
    ray_o = ray_batch["ray_o"]
    draws = render_draws(generator, cfg, ray_o.shape[0], ray_o.dtype,
                         ray_o.device, samples=samples, noise=noise)
    return backbones.of(cfg.backbone).render_rays(
        nets, ray_batch, featmaps, cfg, src_rgbs, src_cameras, draws,
        tables=tables, featmaps_clean=featmaps_clean)
