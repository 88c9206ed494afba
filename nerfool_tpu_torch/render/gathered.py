"""The gathered two-level pipeline IBRNet and GNT share (port of
``nerfool_tpu/render/render_rays.py``): coarse and fine passes on the
per-tap gather (``F.grid_sample``) or, with BSPG specs, the block
segment-patch gather (``ops/bspg.py``); a backbone supplies its ``Steps``.
Hybrid renders (the paper's density-versus-colour analysis) shade the clean
features too, per tap. In bfloat16 the aggregator and its inputs run in
bf16 (the BSPG tables cast before packing, per-tap taps after an f32
gather), its output promoted back; geometry and compositing stay f32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from nerfool_tpu_torch.render.projection import (
    compute_angle_planes,
    epipolar_gather_components,
    inbound_mask_planes,
    project_points_planes,
)
from nerfool_tpu_torch.render.sampling import (sample_along_camera_ray,
                                               sample_fine_zvals)
from nerfool_tpu_torch.utils.profiling import span

# span names by level (0 coarse, 1 fine), of every backbone's render
GATHER = ("render.gather.coarse", "render.gather.fine")
AGGREGATE = ("render.aggregate.coarse", "render.aggregate.fine")
COMPOSITE = ("render.composite.coarse", "render.composite.fine")


@dataclasses.dataclass(frozen=True)
class Steps:
    """What a backbone supplies to the pipeline."""

    # (cfg, net, rgb_feat, ray_diff, mask, pts, ray_d, merged) -> raw, with
    # the inputs already in cfg.dtype
    aggregate: Callable
    # (cfg, raw, z_vals, pixel_mask, noise, raw_clean) -> per-ray outputs;
    # ``noise``: the level's draw or None, ``raw_clean``: the clean
    # features' raw output in a hybrid render, else None
    finalize: Callable
    # the levels a hybrid render shades from the clean features too
    hybrid_levels: tuple = (0, 1)
    # (cfg, dtype) -> whether the aggregator reads the BSPG buffer whole
    # (the whole-chain kernel's [V, R, S, 3 + c + 5] input)
    merged: Callable = lambda cfg, dtype: False


def sample_shapes(cfg, n_rays):
    """The coarse jitter and fine quantiles of stochastic sampling, as
    ``draw_shapes`` gives them; None with ``det``."""
    if cfg.det:
        return None
    i = cfg.n_importance
    return (((n_rays, cfg.n_samples), "uniform"),
            ((n_rays, i), "uniform") if i else None)


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


def shade(steps, cfg, nets, level, rgb_feat, ray_diff, mask, pts, ray_d,
          merged=None):
    """Run the level's aggregator on gathered taps; raw output in f32 (f64
    stays f64).
    ``merged``: the chain's ``[V, R, S, 3 + c + 5]`` input already written
    by the caller (BSPG), ``rgb_feat`` a view of it."""
    with span(AGGREGATE[level]):
        dt = cfg.dtype
        if dt != torch.float32:
            rgb_feat, ray_diff, mask = (rgb_feat.to(dt), ray_diff.to(dt),
                                        mask.to(dt))
            pts, ray_d = pts.to(dt), ray_d.to(dt)
        net = nets["net_coarse" if level == 0 or cfg.single_net
                   else "net_fine"]
        raw = steps.aggregate(cfg, net, rgb_feat, ray_diff, mask, pts, ray_d,
                              merged)
        return raw.to(torch.promote_types(raw.dtype, torch.float32))


def render_rays(steps, nets, ray_batch, featmaps, cfg, src_rgbs, src_cameras,
                draws, tables=None, featmaps_clean=None):
    """Both levels of a batch of rays (``render_rays.render_rays``'s
    arguments); ``draws``: the render's {'samples', 'noise'}. The fine
    level's depths are importance-sampled from the coarse weights."""
    if cfg.hybrid and featmaps_clean is None:
        raise ValueError("hybrid renders need the clean features")
    samples = draws["samples"] or (None, None)
    noise = draws["noise"] or (None, None)
    ray_o, ray_d = ray_batch["ray_o"], ray_batch["ray_d"]
    pts, z_vals = sample_along_camera_ray(
        ray_o, ray_d, ray_batch["depth_range"], cfg.n_samples,
        inv_uniform=cfg.inv_uniform, det=cfg.det, t_rand=samples[0])
    if cfg.bspg_specs is not None and not cfg.hybrid:
        if tables is None:
            tables = make_bspg_tables(src_rgbs, featmaps, cfg.bspg_specs,
                                      cfg.dtype)
        gather = _bspg_gather(steps, cfg, ray_batch, src_cameras, tables)
    else:  # F.grid_sample taps of the attacked or (clean) the clean features
        cam = ray_batch["camera"].reshape(-1)[:34]
        cams = src_cameras.detach() if cfg.stop_camera_grad else src_cameras
        feats = (featmaps, featmaps_clean)

        def gather(pts_l, li, clean):
            rgb, feat, ray_diff, mask = epipolar_gather_components(
                pts_l, cam, src_rgbs, cams, feats[clean][li])
            return torch.cat([rgb, feat], dim=-1), ray_diff, mask, None

    def shade_level(pts_l, li, clean=False):
        with span(GATHER[li]):
            rgb_feat, ray_diff, mask, merged = gather(pts_l, li, clean)
        raw = shade(steps, cfg, nets, li, rgb_feat, ray_diff, mask, pts_l,
                    ray_d, merged)
        return raw, torch.sum(mask[..., 0], dim=0) > 1

    def run_level(pts_l, z_l, li):
        raw, pixel_mask = shade_level(pts_l, li)
        clean = None
        if cfg.hybrid and li in steps.hybrid_levels:
            clean, _ = shade_level(pts_l, li, clean=True)
        with span(COMPOSITE[li]):
            return steps.finalize(cfg, raw, z_l, pixel_mask, noise[li], clean)

    coarse = run_level(pts, z_vals, 0)
    ret = {"outputs_coarse": coarse, "outputs_fine": None}
    if cfg.n_importance > 0:
        with span("render.fine_sampler"):
            z_all = sample_fine_zvals(z_vals, coarse["weights"].detach(),
                                      cfg.n_importance,
                                      inv_uniform=cfg.inv_uniform,
                                      det=cfg.det, u=samples[1])
            pts_fine = (z_all[..., None] * ray_d[:, None, :]
                        + ray_o[:, None, :])
        ret["outputs_fine"] = run_level(pts_fine, z_all, 1)
    return ret


def _bspg_gather(steps, cfg, ray_batch, src_cameras, tables):
    """gather(points, level, clean) -> (taps [V, R, S, 3 + c], ray
    differences, mask, the whole buffer or None) through the block
    segment-patch gather.

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
    ray_o, ray_d = ray_batch["ray_o"], ray_batch["ray_d"]
    r = ray_o.shape[0]
    if r % npb:
        raise ValueError(f"BSPG needs block-major rays: {r} % {npb} != 0")
    b = r // npb
    v = src_cameras.shape[0]
    for spec in cfg.bspg_specs:
        if sorted(i for views, _ in spec.groups for i in views) != list(range(v)):
            raise ValueError(f"BSPG plan covers views {spec.groups}, the "
                             f"render has {v} source views")
    cam = ray_batch["camera"].reshape(-1)[:34]
    h, w = src_cameras[0, :2]
    near, far = ray_batch["depth_range"].reshape(-1)[:2]

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
    ci = 3 + c_feat
    chain = steps.merged(cfg, tables["rgb"].dtype)

    def gather(pts_l, li, clean):
        s = pts_l.shape[1]
        flat = pts_l.reshape(-1, 3)
        px, py, front = project_points_planes(flat, src_cameras)
        gxb = (2.0 * px / (w - 1.0) - 1.0).reshape(v, b, npb, s)
        gyb = (2.0 * py / (h - 1.0) - 1.0).reshape(v, b, npb, s)
        dt = tables["rgb"].dtype
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
        return buf[..., :ci], ray_diff, mask, buf if chain else None

    return gather
