"""Whole-frame rendering (port of ``nerfool_tpu/render/render_image.py``): a
plain loop over ray chunks.

With BSPG specs the rays are first reordered into bh x bw pixel blocks
(padding rays replicate the border pixel), rendered block-major in chunks of
whole blocks, and put back in raster order before the image reshape. A
``chunk_size`` that is not a multiple of the block is rounded down to one (at
least one block), and that is said once per chunk size and block. Hybrid
renders (``featmaps_clean`` with ``use_clean_color`` / ``use_clean_density``)
take the per-tap gather, as in JAX.

Given a ``RaySplit`` (``parallel/mesh.py``) each rank of the group renders
a contiguous share of the chunk list (on the BSPG route whole ray blocks,
since a chunk is) and the shares are gathered back in block-major order, so
that every rank holds the whole frame. The renders' draws are then taken
for every chunk on every rank, in the order the one-process loop takes
them, and each rank uses its chunks' draws (``render_rays.share_draws``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nerfool_tpu_torch import backbones
from nerfool_tpu_torch.render.gathered import make_bspg_tables
from nerfool_tpu_torch.render.render_rays import (RenderConfig, render_rays,
                                                  share_draws)
from nerfool_tpu_torch.utils.cameras import frame_batch
from nerfool_tpu_torch.utils.profiling import span

_said_chunks = set()  # (chunk_size, bh, bw) already rounded down aloud


def block_chunk(chunk_size, bh, bw):
    """``chunk_size`` rounded down to whole bh x bw ray blocks, at least
    one; the first rounding of each (chunk, block) is printed."""
    blk = bh * bw
    chunk = max(blk, chunk_size // blk * blk)
    if chunk != chunk_size and (chunk_size, bh, bw) not in _said_chunks:
        _said_chunks.add((chunk_size, bh, bw))
        print(f"chunk_size {chunk_size} is not a multiple of the {bh}x{bw} "
              f"ray block: BSPG renders take chunks of {chunk} rays",
              flush=True)
    return chunk


def block_major_order(hs, ws, bh, bw):
    """(perm, inv): ``perm`` maps block-major positions of the frame padded
    to whole blocks onto raster ray indices; ``inv`` maps raster rays onto
    their block-major position."""
    hp = -(-hs // bh) * bh
    wp = -(-ws // bw) * bw
    yy, xx = np.meshgrid(np.arange(hp), np.arange(wp), indexing="ij")
    src_idx = np.minimum(yy, hs - 1) * ws + np.minimum(xx, ws - 1)
    perm = (src_idx.reshape(hp // bh, bh, wp // bw, bw)
            .transpose(0, 2, 1, 3).reshape(-1))
    yr, xr = np.meshgrid(np.arange(hs), np.arange(ws), indexing="ij")
    inv = (((yr // bh) * (wp // bw) + xr // bw) * (bh * bw)
           + (yr % bh) * bw + xr % bw).reshape(-1)
    return perm, inv


def render_single_image(nets, ray_batch, featmaps, cfg: RenderConfig, h, w,
                        src_rgbs, src_cameras, chunk_size=4096,
                        render_stride=1, featmaps_clean=None, generator=None,
                        split=None):
    """Render a full frame; outputs reshaped to (H', W', ...).
    ``featmaps_clean``: the clean branch of hybrid renders; ``generator``:
    the source of the renders' draws (``render_rays.render_draws``);
    ``split``: a ``parallel.mesh.RaySplit`` sharing the chunks among the
    ranks of a group (None: one process).

    The backbone's ``PAINT_EMPTY_COARSE`` (IBRNet's, the reference's
    contract) paints the coarse rgb white where the ray mask is empty; the
    fine rgb is not painted.
    """
    hs = len(range(0, h, render_stride))
    ws = len(range(0, w, render_stride))
    ray_o, ray_d = ray_batch["ray_o"], ray_batch["ray_d"]
    inv = None
    tables = None
    if cfg.hybrid:
        cfg = dataclasses.replace(cfg, bspg_specs=None)
    if cfg.bspg_specs is not None:
        bh, bw = cfg.bspg_specs[0].block
        chunk_size = block_chunk(chunk_size, bh, bw)
        perm, inv = block_major_order(hs, ws, bh, bw)
        perm = torch.as_tensor(perm, device=ray_o.device)
        inv = torch.as_tensor(inv, device=ray_o.device)
        ray_o, ray_d = ray_o[perm], ray_d[perm]
        tables = make_bspg_tables(src_rgbs, featmaps, cfg.bspg_specs,
                                  cfg.dtype)

    n = ray_o.shape[0]
    dtype = torch.promote_types(featmaps[0].dtype, torch.float32)

    def render_rows(rows):
        # a split draws every chunk's draws in the one-process order and
        # keeps its own share's
        draws = [None] * -(-n // chunk_size)
        if split is not None:
            draws = share_draws(generator, cfg, [
                min(chunk_size, n - i) for i in range(0, n, chunk_size)],
                rows, dtype, ray_o.device)
        chunks = []
        for i in range(rows.start, rows.stop, chunk_size):
            batch = dict(ray_batch)
            batch["ray_o"] = ray_o[i:i + chunk_size]
            batch["ray_d"] = ray_d[i:i + chunk_size]
            with span("render.chunk"):
                chunks.append(render_rays(nets, batch, featmaps, cfg,
                                          src_rgbs, src_cameras,
                                          tables=tables,
                                          featmaps_clean=featmaps_clean,
                                          generator=generator,
                                          **(draws[i // chunk_size] or {})))
        return chunks

    # a split concatenates each rank's chunks before the gather
    if split is None:
        chunks = render_rows(slice(0, n))
    else:
        chunks = [split.render(lambda rows: _cat(render_rows(rows)), n,
                               chunk_size)]
    paint = backbones.of(cfg.backbone).PAINT_EMPTY_COARSE
    with span("render.assemble"):
        flat = chunks[0] if len(chunks) == 1 else _cat(chunks)
        ret = {}
        for level, outs in flat.items():
            if outs is None:
                ret[level] = None
                continue
            imgs = {}
            for k, x in outs.items():
                if inv is not None:
                    x = x[inv]  # block-major -> raster
                imgs[k] = x.reshape((hs, ws) + x.shape[1:])
            if level == "outputs_coarse" and paint:
                imgs["rgb"] = torch.where(imgs["mask"][..., None],
                                          imgs["rgb"],
                                          torch.ones_like(imgs["rgb"]))
            ret[level] = imgs
    return ret


def render_sample(bundle, data, cfg: RenderConfig, chunk_size):
    """The whole frame of a dataset sample ``data`` (camera, depth range,
    sources) on the bundle's device, without gradients: (outputs, (h,
    w))."""
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                  device=bundle.device)
    batch, (h, w) = frame_batch(data, t)
    src_rgbs = t(data["src_rgbs"])
    with torch.no_grad():
        return render_single_image(
            bundle.nets, batch, bundle.extract_features(src_rgbs), cfg, h, w,
            src_rgbs, t(data["src_cameras"]).reshape(-1, 34),
            chunk_size=chunk_size), (h, w)


def _cat(chunks):
    """``render_rays`` outputs of consecutive chunks, concatenated."""
    return {level: None if chunks[0][level] is None else {
        k: torch.cat([c[level][k] for c in chunks], dim=0)
        for k in chunks[0][level]}
        for level in ("outputs_coarse", "outputs_fine")}
