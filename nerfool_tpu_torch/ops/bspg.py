"""Block segment-patch gather (BSPG) for whole-frame rendering (port of
``nerfool_tpu/ops/bspg.py`` with full-width slot lists).

An 8x8 block of target pixels has epipolar segments that sweep a narrow tube
in every source view: any sample of any block ray at depth z in [near, far]
projects inside ``center-segment (+) Chebyshev-disc(r)``, r the larger radius
of the near and far corner quads. So patch rows are gathered per (block,
view): the block's center segment is walked at patch granularity and every
path patch contributes its 3x3 neighbourhood (9 + 3*crossings slots, distinct
on a monotone path). Coverage is exact when r + 2 <= P cells, which the host
planner verifies for the scene's cameras. Each sample's exact bilinear tap is
then rebuilt from the patch table, read through the block's slot ids, by
``ops/bspg_select.py``.

The host planner is numpy; the walk and the selection run on the render
device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from nerfool_tpu_torch.ops.bspg_select import _view_index, select_taps
from nerfool_tpu_torch.ops.spg import (
    EPS_Z,
    SPGSpec,
    _axis_crossings,
    _clip_segment,
    _clip_segment_np,
    _patch_grid,
)

# slot granularity of the planner's cost model: slot lists are costed in
# multiples of 8, so the port picks the patch size the JAX planner picks
KB = 8


@dataclasses.dataclass(frozen=True)
class BSPGSpec:
    """Static description of a block gather."""

    p: int
    h: int                 # sampled grid dims
    w: int
    h_full: int
    w_full: int
    pby: int
    pbx: int
    block: Tuple[int, int]  # (bh, bw) rays per block
    groups: Tuple[Tuple[Tuple[int, ...], int], ...]  # ((views), K_path)

    @property
    def sy(self):
        return 1.0 if self.h_full <= 1 else (self.h - 1) / (self.h_full - 1)

    @property
    def sx(self):
        return 1.0 if self.w_full <= 1 else (self.w - 1) / (self.w_full - 1)

    def k_slots(self, k_path):
        return 9 + 3 * (k_path - 1)

    def as_spg(self) -> SPGSpec:
        return SPGSpec(p=self.p, h=self.h, w=self.w, h_full=self.h_full,
                       w_full=self.w_full, pby=self.pby, pbx=self.pbx,
                       groups=self.groups)


def plan_block_groups(target_cams, src_cams, depth_range, hw_sample, p,
                      block=(8, 8), margin=2, bucket=2, n_groups=3,
                      render_stride=1):
    """Host planner: per-view center-path crossing budgets K_path for ray
    blocks, plus the check that the tube radius fits the 1-ring dilation
    (r + 2 <= p cells).

    :return: (groups, r_max_cells)
    :raises ValueError: when a view violates the convexity or dilation bound
    """
    target_cams = np.asarray(target_cams, np.float64).reshape(-1, 34)
    src_cams = np.asarray(src_cams, np.float64).reshape(-1, 34)
    near, far = float(depth_range[0]), float(depth_range[1])
    h_s, w_s = hw_sample
    v = src_cams.shape[0]
    k_v = np.zeros(v, np.int64)
    r_max = 0.0
    bh, bw = block

    for tcam in target_cams:
        h, w = int(tcam[0]), int(tcam[1])
        intr = tcam[2:18].reshape(4, 4)
        c2w = tcam[18:34].reshape(4, 4)
        # block-corner ray grid: block corners at pixel offsets {0, b-1}*stride
        ys0 = np.arange(0, h, bh * render_stride, dtype=np.float64)
        xs0 = np.arange(0, w, bw * render_stride, dtype=np.float64)
        cy = np.stack(np.meshgrid(ys0, xs0, indexing="ij"), -1).reshape(-1, 2)
        corners = []
        for dy in (0.0, (bh - 1) * render_stride):
            for dx in (0.0, (bw - 1) * render_stride):
                corners.append(cy + np.array([dy, dx]))
        corners = np.stack(corners, 1)  # [B, 4, 2] (y, x)
        # pixel convention matches utils.cameras.get_rays (no half-pixel shift)
        pix = np.concatenate(
            [corners[..., 1:2], corners[..., 0:1],
             np.ones_like(corners[..., :1])], axis=-1,
        ).reshape(-1, 3).T  # [3, B*4]
        dirs = c2w[:3, :3] @ (np.linalg.inv(intr[:3, :3]) @ pix)
        o = c2w[:3, 3:4]
        for vi, scam in enumerate(src_cams):
            hf, wf = scam[0], scam[1]
            sy = 1.0 if hf <= 1 else (h_s - 1) / (hf - 1)
            sx = 1.0 if wf <= 1 else (w_s - 1) / (wf - 1)
            proj = scam[2:18].reshape(4, 4) @ np.linalg.inv(
                scam[18:34].reshape(4, 4))
            pa = (proj[:3, :3] @ (o + dirs * near) + proj[:3, 3:4]
                  ).reshape(3, -1, 4)  # [3, B, 4] homogeneous corners @near
            pb = (proj[:3, :3] @ (o + dirs * far) + proj[:3, 3:4]
                  ).reshape(3, -1, 4)
            # center segment = mean of HOMOGENEOUS corners (projection is
            # linear in homogeneous space, so this IS the block-center ray)
            ca_h, cb_h = pa.mean(axis=2), pb.mean(axis=2)  # [3, B]
            qa, qb = _clip_segment_np(ca_h, cb_h, w_s, h_s, sx, sy, margin=p)
            cbs = lambda x: np.floor(x).astype(np.int64) + 1
            kx = np.abs(cbs(qa[0]) // p - cbs(qb[0]) // p)
            ky = np.abs(cbs(qa[1]) // p - cbs(qb[1]) // p)
            k_v[vi] = max(k_v[vi], int((kx + ky).max()) + 1)

            # tube radius: max corner deviation from center at MATCHED depths
            # over a dense z grid, counting only view-relevant blocks (center
            # projection inside the margin-expanded rect, or a corner inside
            # the base rect). A z-flip on a relevant block breaks the
            # convexity argument -> reject.
            scl = np.array([[sx], [sy]])
            rect_lo = np.array([[-1.0 - p], [-1.0 - p]])
            rect_hi = np.array([[w_s + p], [h_s + p]])
            in_lo = np.array([[-1.0], [-1.0]])
            in_hi = np.array([[float(w_s)], [float(h_s)]])
            zg = np.geomspace(near, far, 24)
            flip_rel = False
            for z in zg:
                t = (z - near) / (far - near)
                phc = ca_h + t * (cb_h - ca_h)      # [3, B]
                ph = pa + t * (pb - pa)             # [3, B, 4]
                okc = phc[2] > EPS_Z
                qc = np.where(okc, phc[:2] / np.clip(phc[2], EPS_Z, None),
                              np.inf) * scl
                okk = ph[2] > EPS_Z                 # [B, 4]
                qk = np.where(okk, ph[:2] / np.clip(ph[2], EPS_Z, None),
                              np.inf) * scl[..., None]
                corner_in = ((qk >= in_lo[..., None]).all(0)
                             & (qk <= in_hi[..., None]).all(0)).any(1)
                rel = (okc & (qc >= rect_lo).all(0)
                       & (qc <= rect_hi).all(0)) | corner_in
                if not rel.any():
                    continue
                if (~okk.all(axis=1) & rel).any():
                    flip_rel = True
                    break
                with np.errstate(invalid="ignore"):  # inf - inf off-view
                    dev = np.abs(qk - qc[:, :, None]).max(axis=(0, 2))
                r_max = max(r_max, float(dev[rel].max()))
            if flip_rel:
                raise ValueError(
                    "BSPG convexity bound violated: a view-relevant ray block "
                    "crosses the source camera plane"
                )

    if r_max + 2.0 > p:
        raise ValueError(
            f"BSPG dilation bound violated: tube radius {r_max:.1f} cells + 2 "
            f"> patch size {p}; use a larger p or a smaller ray block"
        )
    cap = _patch_grid(h_s, p) + _patch_grid(w_s, p) - 1
    k_v = np.minimum(k_v + margin, cap)
    k_v = -(-k_v // bucket) * bucket
    uniq = sorted(set(int(k) for k in k_v))
    while len(uniq) > n_groups:
        gaps = [uniq[i + 1] - uniq[i] for i in range(len(uniq) - 1)]
        i = int(np.argmin(gaps))
        lo = uniq.pop(i)
        k_v[k_v == lo] = uniq[i]
    groups = []
    for k in sorted(set(int(x) for x in k_v)):
        views = tuple(int(i) for i in np.where(k_v == k)[0])
        groups.append((views, int(k)))
    return tuple(groups), r_max


def make_block_spec(groups, p, hw_sample, hw_full, block=(8, 8)):
    h_s, w_s = hw_sample
    h_f, w_f = hw_full
    return BSPGSpec(
        p=p, h=int(h_s), w=int(w_s), h_full=int(h_f), w_full=int(w_f),
        pby=_patch_grid(int(h_s), p), pbx=_patch_grid(int(w_s), p),
        block=tuple(block), groups=groups,
    )


def plan_render_specs(target_cams, src_cams, depth_range, rgb_hw, feat_hw,
                      block=(8, 8), render_stride=1,
                      feat_ps=(4, 6, 8, 12, 16), rgb_ps=(8, 12, 16, 24, 32),
                      max_slots=None):
    """(spec_feat, spec_rgb) for whole-frame rendering, or None when no patch
    size satisfies the coverage bound.

    Picks the admissible patch size with the least per-sample selection work,
    sum over groups of |views| x slots x (p+1)^2.
    """
    def pick(hw_sample, ps):
        best = None
        best_cost = None
        for p in ps:
            try:
                groups, _ = plan_block_groups(
                    target_cams, src_cams, depth_range, hw_sample, p,
                    block=block, render_stride=render_stride,
                )
            except ValueError:
                continue
            worst = max(9 + 3 * (k - 1) for _, k in groups)
            if max_slots is not None and worst > max_slots:
                continue
            cost = sum(len(v) * (-(-(9 + 3 * (k - 1)) // KB) * KB)
                       * (p + 1) ** 2 for v, k in groups)
            if best_cost is None or cost < best_cost:
                best_cost = cost
                best = make_block_spec(
                    groups, p, hw_sample,
                    (int(target_cams[0][0]), int(target_cams[0][1])),
                    block=block)
        return best

    target_cams = np.asarray(target_cams, np.float64).reshape(-1, 34)
    spec_f = pick(feat_hw, feat_ps)
    if spec_f is None:
        return None
    spec_r = pick(rgb_hw, rgb_ps)
    if spec_r is None:
        return None
    return spec_f, spec_r


def build_block_slots(pa_corners, pb_corners, spec: BSPGSpec):
    """Per (view, block): dilated center-path patch slots.

    :param pa_corners, pb_corners: [V, B, 4, 3] homogeneous projections of the
        4 block-corner rays at near / far
    :return: list over spec.groups of slot tensors [Vg, B, Ks] (int32, -1 pads)
    """
    # center segment = mean of HOMOGENEOUS corner projections, clipped
    # against the rect EXPANDED by p cells so the path keeps tracking the
    # in-rect tube when the center line grazes or exits the border
    cax, cay, cbx, cby = _clip_segment(
        pa_corners.mean(dim=2), pb_corners.mean(dim=2), spec.as_spg(),
        margin=spec.p,
    )
    out = []
    for views, k_path in spec.groups:
        vi = _view_index(views, cax.device)
        out.append(_dilated_walk(cax[vi], cay[vi], cbx[vi], cby[vi], spec,
                                 k_path))
    return out


def _dilated_walk(ax, ay, bx, by, spec: BSPGSpec, k_path):
    """Center-segment patch path + 3x3 dilation: slots [Vg, B, 9+3*(k_path-1)].

    The initial patch contributes its full 3x3 neighbourhood; every
    x-crossing (to pbx') contributes the column (pbx'+sx, pby'+{-1,0,1}),
    every y-crossing the row (pbx'+{-1,0,1}, pby'+sy). Out-of-grid
    neighbours become -1 (never matched).
    """
    p = spec.p
    # UNclamped base cells: the center path may run through the margin zone
    rawcb = lambda x: torch.floor(x).to(torch.int32) + 1
    pbx0 = rawcb(ax) // p
    pbx1 = rawcb(bx) // p
    pby0 = rawcb(ay) // p
    pby1 = rawcb(by) // p

    def pid_of(px, py):
        ok = (px >= 0) & (px < spec.pbx) & (py >= 0) & (py < spec.pby)
        return torch.where(ok, py * spec.pbx + px, torch.full_like(px, -1))

    offs = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    init = torch.stack([pid_of(pbx0 + dx, pby0 + dy) for dy, dx in offs],
                       dim=-1)  # [Vg, B, 9]
    kc = k_path - 1
    if kc == 0:
        return init

    lam_x, sgn_x = _axis_crossings(ax, bx, pbx0, pbx1, p, kc)
    lam_y, sgn_y = _axis_crossings(ay, by, pby0, pby1, p, kc)
    lam = torch.cat([lam_x, lam_y], dim=-1)
    is_x = torch.cat([torch.ones(kc, dtype=torch.int32, device=ax.device),
                      torch.zeros(kc, dtype=torch.int32, device=ax.device)])
    order = torch.argsort(lam, dim=-1, stable=True)
    lam_s = torch.gather(lam, -1, order)
    flag_s = torch.gather(is_x.expand(lam.shape), -1, order)
    fin = torch.isfinite(lam_s).to(torch.int32)
    cum_x = torch.cumsum(flag_s * fin, dim=-1, dtype=torch.int32)
    cum_y = torch.cumsum((1 - flag_s) * fin, dim=-1, dtype=torch.int32)
    pbx_j = pbx0[..., None] + sgn_x[..., None] * cum_x
    pby_j = pby0[..., None] + sgn_y[..., None] * cum_y
    # emitted triple per crossing: the advanced row/col one ahead in the step
    # direction, spanning {-1,0,1} across it
    lead_x = pbx_j + sgn_x[..., None]
    lead_y = pby_j + sgn_y[..., None]
    tris = []
    for d in (-1, 0, 1):
        px = torch.where(flag_s == 1, lead_x, pbx_j + d)
        py = torch.where(flag_s == 1, pby_j + d, lead_y)
        tris.append(torch.where(fin.bool(), pid_of(px, py),
                                torch.full_like(px, -1)))
    tri = torch.stack(tris, dim=-1)  # [Vg, B, 2kc, 3]
    tri = tri[..., :kc, :].reshape(tri.shape[:-2] + (3 * kc,))
    return torch.cat([init, tri], dim=-1)  # [Vg, B, 9+3kc]


def select_block_samples(table, slots_groups, gx, gy, spec: BSPGSpec, c,
                         out=None, offset=0):
    """Exact bilinear taps for every (ray-in-block, sample), read from the
    patch table through each block's slot ids by
    ``bspg_select.select_taps``, one launch per view group.

    :param table: [V, Pby*Pbx, (p+1)^2 * c] packed patch table
    :param gx, gy: [V, B, n, S] normalized coords (n = rays per block)
    :param out: [V, B*n, S, C] buffer the taps are written into at channels
        [offset, offset + c); None allocates [V, B*n, S, c]
    :return: ``out`` ([V, B, n, S, c] when allocated here)
    """
    v, b, n, s = gx.shape
    fresh = out is None
    if fresh:
        out = torch.empty((v, b * n, s, c), dtype=table.dtype,
                          device=table.device)
    gx, gy = gx.contiguous(), gy.contiguous()
    for (views, _), slots in zip(spec.groups, slots_groups):
        select_taps(table, slots, views, gx, gy, out, offset, spec.p, spec.h,
                    spec.w, spec.pbx)
    return out.reshape(v, b, n, s, c) if fresh else out
