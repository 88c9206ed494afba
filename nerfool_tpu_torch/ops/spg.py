"""Segment-patch helpers shared by the block gather (port of the parts of
``nerfool_tpu/ops/spg.py`` that BSPG uses).

A source image (or feature map) is tiled into overlapping (P+1)x(P+1)-pixel
patch rows at stride P. A bilinear tap at continuous coordinate x has base
cell ``cb = clip(floor(x), -1, n-1) + 1`` in the 1-left-padded image; the
patch ``cb // P`` holds all four of its corners, at in-patch offset
``cb - P * (cb // P)`` and the one after it.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

EPS_Z = 1e-6


@dataclasses.dataclass(frozen=True)
class SPGSpec:
    """Static per-table description.

    Projection yields FULL-resolution pixel coords; the sampled grid (feature
    maps at ~1/4 size, or the rgb image itself) rescales them by
    (n_s - 1)/(n_full - 1) per axis (align_corners semantics).
    """

    p: int                       # patch size in cells; patches are (p+1)^2 px
    h: int                       # sampled grid height
    w: int
    h_full: int                  # full-res height (projection pixel space)
    w_full: int
    pby: int                     # patch grid dims
    pbx: int
    # view groups: ((view indices), K) with a shared patch budget K
    groups: Tuple[Tuple[Tuple[int, ...], int], ...]

    @property
    def sy(self):
        return 1.0 if self.h_full <= 1 else (self.h - 1) / (self.h_full - 1)

    @property
    def sx(self):
        return 1.0 if self.w_full <= 1 else (self.w - 1) / (self.w_full - 1)


def _patch_grid(n, p):
    """#patches along an axis of n pixels: base cells cb span [0, n]."""
    return -(-(n + 1) // p)  # ceil((n+1)/p)


def _clip_segment_np(pa, pb, w_s, h_s, sx=1.0, sy=1.0, margin=0.0):
    """Clip homogeneous segment pa->pb (numpy, planner only): keep the z>eps
    part, divide, rescale to the sampled grid, Liang-Barsky clip to
    [-1-margin, w_s+margin] x [-1-margin, h_s+margin].

    The rect reaches one cell past the last pixel on each side: taps at x in
    (n-1, n) still contribute through their in-range corner and clamp to base
    cell n, so the walk must cover that cell's patch.
    """
    za, zb = pa[2], pb[2]
    dz = zb - za
    t_at = lambda z0: np.where(np.abs(dz) > 1e-12, (EPS_Z - z0) / np.where(
        np.abs(dz) > 1e-12, dz, 1.0), 0.0)
    t0 = np.where(za > EPS_Z, 0.0, np.clip(t_at(za), 0.0, 1.0))
    t1 = np.where(zb > EPS_Z, 1.0, np.clip(t_at(za), 0.0, 1.0))
    t1 = np.maximum(t1, t0)
    qa_h = pa + t0 * (pb - pa)
    qb_h = pa + t1 * (pb - pa)
    scale = np.array([[sx], [sy]])
    div = lambda ph: np.clip(
        ph[:2] / np.clip(ph[2], EPS_Z, None), -1e6, 1e6
    ) * scale
    qa, qb = div(qa_h), div(qb_h)
    d = qb - qa
    s0 = np.zeros(qa.shape[1])
    s1 = np.ones(qa.shape[1])
    m = float(margin)
    for axis, lo, hi in ((0, -1.0 - m, w_s + m), (1, -1.0 - m, h_s + m)):
        for pq, q in ((-d[axis], qa[axis] - lo), (d[axis], hi - qa[axis])):
            with np.errstate(divide="ignore", invalid="ignore"):
                r = np.where(np.abs(pq) > 1e-12, q / np.where(
                    np.abs(pq) > 1e-12, pq, 1.0), 0.0)
            s0 = np.where(pq < 0, np.maximum(s0, r), s0)
            s1 = np.where(pq > 0, np.minimum(s1, r), s1)
            s1 = np.where((np.abs(pq) <= 1e-12) & (q < 0), -1.0, s1)
    bad = s1 < s0
    s0 = np.where(bad, 0.0, s0)
    s1 = np.where(bad, 0.0, s1)
    lohi = lambda q: np.clip(q, [[-1.0 - m], [-1.0 - m]],
                             [[w_s + m], [h_s + m]])
    return lohi(qa + s0 * d), lohi(qa + s1 * d)


def pack_patch_table(images, p):
    """[V, H, W, C] -> patch table [V, Pby*Pbx, (P+1)*(P+1)*C].

    Row (pby, pbx) holds the padded pixels [pby*P .. pby*P+P] x [pbx*P ..
    pbx*P+P] (pixel index in the 1-left-padded image = base cell), channel
    layout [dy, dx, C].
    """
    v, h, w, c = images.shape
    pby, pbx = _patch_grid(h, p), _patch_grid(w, p)
    pad_y = max(0, pby * p + 1 - (h + 2))
    pad_x = max(0, pbx * p + 1 - (w + 2))
    padded = F.pad(images, (0, 0, 1, 1 + pad_x, 1, 1 + pad_y))
    # [V, Pby, P+1, Pbx, P+1, C] windows at stride P, then row-major patches
    t = padded.unfold(1, p + 1, p).unfold(2, p + 1, p)  # [V,Pby,Pbx,C,dy,dx]
    t = t[:, :pby, :pbx].permute(0, 1, 2, 4, 5, 3)
    return t.reshape(v, pby * pbx, (p + 1) * (p + 1) * c).contiguous()


def project_endpoints(p0, p1, src_cameras):
    """Homogeneous projections of per-ray 3D segment endpoints.

    :param p0, p1: [R, 3] world points
    :return: (pa, pb) each [V, R, 3] homogeneous (x*z, y*z, z)
    """
    intr = src_cameras[:, 2:18].reshape(-1, 4, 4)
    c2w = src_cameras[:, 18:34].reshape(-1, 4, 4)
    proj = intr @ torch.linalg.inv_ex(c2w).inverse

    def prj(pts):
        return (torch.einsum("vij,rj->vri", proj[:, :3, :3], pts)
                + proj[:, None, :3, 3])

    return prj(p0), prj(p1)


def _clip_segment(pa, pb, spec: SPGSpec, margin=0.0):
    """Tensor twin of _clip_segment_np: [V?, R, 3] homogeneous endpoints ->
    clipped continuous SAMPLED-grid coords (ax, ay, bx, by), each [V?, R]."""
    za, zb = pa[..., 2], pb[..., 2]
    dz = zb - za
    safe_dz = torch.where(torch.abs(dz) > 1e-12, dz, torch.ones_like(dz))
    t_flip = torch.clamp((EPS_Z - za) / safe_dz, 0.0, 1.0)
    t0 = torch.where(za > EPS_Z, torch.zeros_like(t_flip), t_flip)
    t1 = torch.where(zb > EPS_Z, torch.ones_like(t_flip), t_flip)
    t1 = torch.maximum(t1, t0)
    qa_h = pa + t0[..., None] * (pb - pa)
    qb_h = pa + t1[..., None] * (pb - pa)

    def div(ph):
        z = torch.clamp(ph[..., 2], min=EPS_Z)
        return (torch.clamp(ph[..., 0] / z, -1e6, 1e6) * spec.sx,
                torch.clamp(ph[..., 1] / z, -1e6, 1e6) * spec.sy)

    ax, ay = div(qa_h)
    bx, by = div(qb_h)
    m = float(margin)
    w_s, h_s = float(spec.w) + m, float(spec.h) + m
    lo = -1.0 - m
    dx, dy = bx - ax, by - ay
    s0 = torch.zeros_like(ax)
    s1 = torch.ones_like(ax)
    for pq, q in (
        (-dx, ax - lo), (dx, w_s - ax),
        (-dy, ay - lo), (dy, h_s - ay),
    ):
        safe = torch.where(torch.abs(pq) > 1e-12, pq, torch.ones_like(pq))
        r = q / safe
        s0 = torch.where(pq < 0, torch.maximum(s0, r), s0)
        s1 = torch.where(pq > 0, torch.minimum(s1, r), s1)
        s1 = torch.where((torch.abs(pq) <= 1e-12) & (q < 0),
                         torch.full_like(s1, -1.0), s1)
    bad = s1 < s0
    s0 = torch.where(bad, torch.zeros_like(s0), s0)
    s1 = torch.where(bad, torch.zeros_like(s1), s1)
    cl = lambda x, n: torch.clamp(x, lo, n)
    return (cl(ax + s0 * dx, w_s), cl(ay + s0 * dy, h_s),
            cl(ax + s1 * dx, w_s), cl(ay + s1 * dy, h_s))


def _cb(x, n):
    """Continuous coord -> padded base-cell index, clip(floor, -1, n-1)+1."""
    return torch.clamp(torch.floor(x), -1.0, n - 1.0).to(torch.int32) + 1


def _axis_crossings(a, b, pb0, pb1, p, kc):
    """Patch-boundary crossings along one axis: lambda values [..., kc] (+inf
    where invalid). Validity is integer-exact: i <= |pb1 - pb0|."""
    d = b - a
    pos = d >= 0
    sgn = torch.where(pos, 1, -1).to(torch.int32)
    i = torch.arange(1, kc + 1, dtype=torch.int32, device=a.device)
    # boundary in continuous coords: cb transitions at x = m*p - 1
    m = torch.where(pos[..., None], pb0[..., None] + i, pb0[..., None] - i + 1)
    bx = m.to(a.dtype) * p - 1.0
    safe_d = torch.where(torch.abs(d) > 1e-12, d, torch.ones_like(d))
    lam = (bx - a[..., None]) / safe_d[..., None]
    valid = i <= torch.abs(pb1 - pb0)[..., None]
    lam = torch.where(valid, torch.clamp(lam, 0.0, 1.0),
                      torch.full_like(lam, float("inf")))
    return lam, sgn


def _sample_ingredients(ix, iy, spec: SPGSpec):
    """Per-sample selection ingredients from UNclipped sampled-grid coords:
    patch id, in-patch offsets, bilinear fractions and per-corner
    zero-padding validity (``F.grid_sample`` zeros-padding semantics)."""
    p = spec.p
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    fx = ix - x0
    fy = iy - y0
    cbx = _cb(ix, spec.w)
    cby = _cb(iy, spec.h)
    pbx = cbx // p
    pby = cby // p
    pid = pby * spec.pbx + pbx
    lx = cbx - pbx * p  # [0, P-1]
    ly = cby - pby * p
    vld = lambda c0, n: ((c0 >= 0) & (c0 <= n - 1)).to(ix.dtype)
    return dict(
        pid=pid, ly=ly, fy=fy, vy0=vld(y0, spec.h), vy1=vld(y0 + 1, spec.h),
        lx=lx, fx=fx, vx0=vld(x0, spec.w), vx1=vld(x0 + 1, spec.w),
    )
