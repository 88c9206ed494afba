"""Ray renderer (port of ``nerfool_tpu/render/render_rays.py``): coarse and
fine passes over a batch of rays, on the per-tap route (``F.grid_sample`` per
sample and view) or on the block segment-patch route (``ops/bspg.py``) when
the config carries BSPG specs. The two backbones share the pipeline and
differ in the aggregator and in how its raw output becomes radiance:

  * ibrnet: aggregator -> [R, S, 4] raw, alpha-composited by raw2outputs
  * gnt:    aggregator -> [R, 3 (+ S)] rgb (+ attention weights as density)

Hybrid renders (``use_clean_color`` / ``use_clean_density``, the paper's
density-versus-colour analysis) shade the clean features beside the attacked
ones on the per-tap route and mix the two: IBRNet takes raw colour or sigma
from the clean branch at both levels; GNT takes rgb or the attention weights
from the clean branch at the coarse level only, keeps the attacked depth, and
renders the fine level from the attacked features (the reference's quirks,
kept). ``geo_noise`` adds Gaussian noise to IBRNet's sigma before
compositing, drawn from the caller's generator or handed in. Training
samples stochastically (``det=False``): the coarse depths' jitter and the
fine level's quantiles come from the same generator, or are handed in.

In bfloat16 (``compute_dtype``) the aggregator and its inputs run in bf16:
the BSPG patch tables are cast before packing, and the gathered taps, ray
differences, mask, points and ray directions before the aggregator, whose
output is promoted back to f32. IBRNet's parameters are cast to bf16 on each
call (``torch.func.functional_call``), as the JAX package casts its
parameter tree, so a weight update needs no restack; GNT's layers cast their
weights to their operands' dtype. Geometry, projection and compositing stay
f32. Per-tap renders gather in f32 and cast the taps.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from nerfool_tpu_torch.render.compositor import raw2outputs
from nerfool_tpu_torch.render.projection import (
    compute_angle_planes,
    epipolar_gather_components,
    inbound_mask_planes,
    project_points_planes,
)
from nerfool_tpu_torch.render.sampling import (
    sample_along_camera_ray,
    sample_fine_zvals,
)


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
    backbone: str = "ibrnet"  # 'ibrnet' | 'gnt'
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
    # the TPU kernel's lane-packed formulation of the same function: routes
    # to the same kernel; only meaningful with gnt_fused_vt
    gnt_fused_vt_lp: bool = False
    # (spec_feat, spec_rgb) BSPGSpec pair from the host planner: rays arrive
    # block-major and taps are rebuilt from per-(block, view) patch rows;
    # None keeps the per-tap gather
    bspg_specs: Optional[tuple] = None

    @property
    def hybrid(self):
        return self.use_clean_color or self.use_clean_density

    @property
    def dtype(self):
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.compute_dtype]


def make_bspg_tables(src_rgbs, featmaps, bspg_specs, dtype=torch.float32):
    """Patch tables for the block gather, cast to ``dtype`` and packed once
    per frame: {'rgb': [V, P, row], 'feat': (coarse, fine)}."""
    from nerfool_tpu_torch.ops.spg import pack_patch_table

    spec_f, spec_r = bspg_specs
    return {
        "rgb": pack_patch_table(src_rgbs.to(dtype), spec_r.p),
        "feat": tuple(pack_patch_table(f.to(dtype), spec_f.p)
                      for f in featmaps),
    }


def _chain_route(cfg, dtype):
    """Whether a level's taps of ``dtype`` go to the whole-chain kernel."""
    return (cfg.backbone == "gnt" and cfg.gnt_fused_chain
            and dtype == torch.bfloat16)


def _shade(cfg, nets, level, rgb_feat, ray_diff, mask, pts, ray_d,
           merged=None):
    """Run the level's aggregator on gathered taps; raw output in f32 (f64
    stays f64).
    ``merged``: the chain's ``[V, R, S, 3 + c + 5]`` input already written
    by the caller (BSPG), ``rgb_feat`` a view of it."""
    dt = cfg.dtype
    if dt != torch.float32:
        rgb_feat, ray_diff, mask = (rgb_feat.to(dt), ray_diff.to(dt),
                                    mask.to(dt))
        pts, ray_d = pts.to(dt), ray_d.to(dt)
    net = nets["net_coarse" if level == 0 or cfg.single_net else "net_fine"]
    if cfg.backbone == "ibrnet":
        if dt != torch.float32:
            params = {k: p.to(dt) for k, p in net.named_parameters()}
            raw = torch.func.functional_call(net, params,
                                             (rgb_feat, ray_diff, mask))
        else:
            raw = net(rgb_feat, ray_diff, mask)
    elif _chain_route(cfg, rgb_feat.dtype):
        from nerfool_tpu_torch.ops.chain import fused_chain_aggregate

        raw = fused_chain_aggregate(net, rgb_feat, ray_diff, mask, pts, ray_d,
                                    merged)
    else:
        raw = net(rgb_feat, ray_diff, mask, pts, ray_d,
                  fused_attn=cfg.gnt_fused_attn, fused_vt=cfg.gnt_fused_vt,
                  fused_vt_lp=cfg.gnt_fused_vt_lp)
    return raw.to(torch.promote_types(raw.dtype, torch.float32))


def _finalize(cfg, raw, z_vals, pixel_mask, noise=None):
    """Raw aggregator output -> per-ray outputs. GNT: rgb directly, the
    attention row as compositing weights, no validity mask, no noise."""
    if cfg.backbone == "ibrnet":
        return raw2outputs(raw, z_vals, pixel_mask, white_bkgd=cfg.white_bkgd,
                           geo_noise=cfg.geo_noise, noise=noise)
    if not cfg.ret_alpha:
        return {"rgb": raw}
    weights = raw[:, 3:]
    return {"rgb": raw[:, :3], "weights": weights,
            "depth": torch.sum(weights * z_vals, dim=-1)}


def render_rays(nets, ray_batch, featmaps, cfg: RenderConfig, src_rgbs,
                src_cameras, tables=None, featmaps_clean=None, generator=None,
                noise=None, samples=None):
    """Render a batch of rays (coarse + optional fine pass).

    :param nets: {'net_coarse', 'net_fine'} aggregator modules
    :param ray_batch: ray_o [R,3], ray_d [R,3], depth_range [1,2], camera
        [1,34]; block-major rays when cfg.bspg_specs is set
    :param featmaps: (coarse, fine) each [V, Hf, Wf, C]
    :param src_rgbs: [V, H, W, 3]; src_cameras: [V, 34]
    :param tables: BSPG patch tables from make_bspg_tables (built here when
        None and the config asks for BSPG)
    :param featmaps_clean: the clean sources' (coarse, fine) features, for
        hybrid renders (which take the per-tap gather)
    :param generator: the ``torch.Generator`` of the ``geo_noise`` draws
        and, with ``cfg.det`` False, of the sampling draws
    :param noise: (coarse [R, S], fine [R, S + I]) standard normal draws
        used instead of the generator's
    :param samples: with ``cfg.det`` False, (coarse [R, S], fine [R, I])
        U[0, 1) draws (the coarse depths' jitter, the fine quantiles) used
        instead of the generator's; either may be None
    :return: {'outputs_coarse': {...}, 'outputs_fine': {...} | None}
    """
    if cfg.hybrid and featmaps_clean is None:
        raise ValueError("hybrid renders need the clean features")
    samples = samples if samples is not None else (None, None)
    pts, z_vals = sample_along_camera_ray(
        ray_batch["ray_o"], ray_batch["ray_d"], ray_batch["depth_range"],
        cfg.n_samples, inv_uniform=cfg.inv_uniform, det=cfg.det,
        generator=generator, t_rand=samples[0])
    if cfg.bspg_specs is not None and not cfg.hybrid:
        if tables is None:
            tables = make_bspg_tables(src_rgbs, featmaps, cfg.bspg_specs,
                                      cfg.dtype)
        return _render_rays_bspg(nets, ray_batch, cfg, src_cameras, tables,
                                 pts, z_vals, generator, noise, samples[1])

    cam = ray_batch["camera"].reshape(-1)[:34]
    cams = src_cameras.detach() if cfg.stop_camera_grad else src_cameras

    def shade(pts_l, li, feats):
        rgb, feat, ray_diff, mask = epipolar_gather_components(
            pts_l, cam, src_rgbs, cams, feats[li])
        raw = _shade(cfg, nets, li, torch.cat([rgb, feat], dim=-1), ray_diff,
                     mask, pts_l, ray_batch["ray_d"])
        return raw, torch.sum(mask[..., 0], dim=0) > 1

    def run_level(pts_l, z_l, li):
        raw, pixel_mask = shade(pts_l, li, featmaps)
        if cfg.hybrid and (cfg.backbone == "ibrnet" or li == 0):
            raw_clean, _ = shade(pts_l, li, featmaps_clean)
            if cfg.backbone == "ibrnet":
                raw = torch.cat([
                    (raw_clean if cfg.use_clean_color else raw)[..., :3],
                    (raw_clean if cfg.use_clean_density else raw)[..., 3:4]],
                    dim=-1)
            else:  # the attacked depth either way
                out = _finalize(cfg, raw, z_l, pixel_mask)
                clean = _finalize(cfg, raw_clean, z_l, pixel_mask)
                if cfg.use_clean_color:
                    out["rgb"] = clean["rgb"]
                if cfg.use_clean_density:
                    out["weights"] = clean["weights"]
                return out
        return _finalize(cfg, raw, z_l, pixel_mask,
                         _noise(cfg, noise, generator, li, raw))

    return _two_levels(cfg, run_level, pts, z_vals, ray_batch["ray_o"],
                       ray_batch["ray_d"], generator, samples[1])


def _noise(cfg, noise, generator, li, raw):
    """The level's standard normal draw for ``geo_noise`` (IBRNet), or
    None."""
    if cfg.backbone != "ibrnet" or not cfg.geo_noise > 0:
        return None
    if noise is not None:
        return noise[li]
    return torch.randn(raw.shape[:2], generator=generator, dtype=raw.dtype,
                       device=raw.device)


def noise_draws(generator, render_cfg: RenderConfig, n_rays, dtype, device):
    """The standard normal ``geo_noise`` draws that ``render_rays`` takes
    from ``generator`` for ``n_rays`` rays (coarse [R, S], then fine
    [R, S + I]; IBRNet only), or None: drawn for the whole batch on every
    rank of a split, so that each rank slices its share and the generators
    stay in step."""
    if render_cfg.backbone != "ibrnet" or not render_cfg.geo_noise > 0:
        return None
    s, i = render_cfg.n_samples, render_cfg.n_importance
    draw = lambda k: torch.randn((n_rays, k), generator=generator,
                                 dtype=dtype, device=device)
    return (draw(s), draw(s + i) if i else None)


def _two_levels(cfg, run_level, pts, z_vals, ray_o, ray_d, generator,
                u_fine):
    """The coarse level, then the fine one at importance-sampled depths
    (``u_fine``: the fine quantiles when sampling stochastically, or None
    to draw them from ``generator``)."""
    coarse = run_level(pts, z_vals, 0)
    ret = {"outputs_coarse": coarse, "outputs_fine": None}
    if cfg.n_importance > 0:
        z_all = sample_fine_zvals(z_vals, coarse["weights"].detach(),
                                  cfg.n_importance,
                                  inv_uniform=cfg.inv_uniform, det=cfg.det,
                                  generator=generator, u=u_fine)
        pts_fine = z_all[..., None] * ray_d[:, None, :] + ray_o[:, None, :]
        ret["outputs_fine"] = run_level(pts_fine, z_all, 1)
    return ret


def _render_rays_bspg(nets, ray_batch, cfg, src_cameras, tables, pts, z_vals,
                      generator, noise, u_fine):
    """Coarse + fine rendering through the block segment-patch gather.

    Rays arrive BLOCK-MAJOR (render_image reorders raster rays into bh x bw
    pixel blocks). One slot walk per (block, view) serves both passes: fine
    depths stay inside [near, far], which the block tube covers by
    construction. The selection writes rgb and the features side by side
    into the one [V, R, S, 3 + c] buffer the aggregator reads; for the
    whole-chain kernel that buffer is its [V, R, S, 3 + c + 5] input, the
    ray differences and the mask written beside the taps.
    """
    from nerfool_tpu_torch.ops.bspg import (
        build_block_slots,
        select_block_samples,
    )
    from nerfool_tpu_torch.ops.spg import project_endpoints

    spec_f, spec_r = cfg.bspg_specs
    bh, bw = spec_f.block
    npb = bh * bw
    r = pts.shape[0]
    if r % npb:
        raise ValueError(f"BSPG needs block-major rays: {r} % {npb} != 0")
    b = r // npb
    v = src_cameras.shape[0]
    for spec in cfg.bspg_specs:
        if sorted(i for views, _ in spec.groups for i in views) != list(range(v)):
            raise ValueError(f"BSPG plan covers views {spec.groups}, the "
                             f"render has {v} source views")
    cam = ray_batch["camera"].reshape(-1)[:34]
    h = src_cameras[0, 0]
    w = src_cameras[0, 1]

    ray_o, ray_d = ray_batch["ray_o"], ray_batch["ray_d"]
    near = ray_batch["depth_range"].reshape(-1)[0]
    far = ray_batch["depth_range"].reshape(-1)[1]

    def corners(x):  # [b*npb, 3] -> the 4 block-corner rays [b, 4, 3]
        x = x.reshape(b, bh, bw, 3)
        return torch.stack([x[:, 0, 0], x[:, 0, bw - 1], x[:, bh - 1, 0],
                            x[:, bh - 1, bw - 1]], dim=1)

    ro_c, rd_c = corners(ray_o), corners(ray_d)
    pa, pb = project_endpoints((ro_c + rd_c * near).reshape(-1, 3),
                               (ro_c + rd_c * far).reshape(-1, 3), src_cameras)
    pa = pa.reshape(v, b, 4, 3)
    pb = pb.reshape(v, b, 4, 3)

    slots_f = build_block_slots(pa, pb, spec_f)
    slots_r = build_block_slots(pa, pb, spec_r)
    c_feat = tables["feat"][0].shape[-1] // (spec_f.p + 1) ** 2

    def run_level(pts_l, z_l, li):
        s = pts_l.shape[1]
        flat = pts_l.reshape(-1, 3)
        px, py, front = project_points_planes(flat, src_cameras)
        gxb = (2.0 * px / (w - 1.0) - 1.0).reshape(v, b, npb, s)
        gyb = (2.0 * py / (h - 1.0) - 1.0).reshape(v, b, npb, s)
        dt = tables["rgb"].dtype
        chain = _chain_route(cfg, dt)
        ci = 3 + c_feat
        buf = torch.empty((v, r, s, ci + (5 if chain else 0)), dtype=dt,
                          device=flat.device)
        select_block_samples(tables["rgb"], slots_r, gxb, gyb, spec_r, 3,
                             buf, 0)
        select_block_samples(tables["feat"][li], slots_f, gxb, gyb, spec_f,
                             c_feat, buf, 3)
        dxp, dyp, dzp, dot = compute_angle_planes(flat, cam, src_cameras)
        ray_diff = torch.stack([dxp, dyp, dzp, dot], dim=-1).reshape(v, r, s, 4)
        mask = (inbound_mask_planes(px, py, h, w) & front).to(dt).reshape(
            v, r, s, 1)
        if chain:
            buf[..., ci:ci + 4] = ray_diff
            buf[..., ci + 4:] = mask
        raw = _shade(cfg, nets, li, buf[..., :ci], ray_diff, mask, pts_l,
                     ray_d, buf if chain else None)
        pixel_mask = torch.sum(mask[..., 0], dim=0) > 1
        return _finalize(cfg, raw, z_l, pixel_mask,
                         _noise(cfg, noise, generator, li, raw))

    return _two_levels(cfg, run_level, pts, z_vals, ray_o, ray_d, generator,
                       u_fine)
