"""BSPG tap selection: the hand-written CUDA kernel ``csrc/bspg_select.cu``
and its plain PyTorch version.

Contract, for each (view-row rv, sample s), with G the row's gathered patch
rows ``G[rv, k] = table[view(rv), slots[rv, k]]``::

    out[rv, s] = sum_{k : slots[rv, k] == pid[rv, s]}
                 sum_{dy in {0,1}, dx in {0,1}}
                 w_y[dy] * w_x[dx] * G[rv, k, (ly+dy)*(p+1) + (lx+dx), :]

with ``w_y = (wy0, wy1)`` and ``w_x = (wx0, wx1)``, and ``pid``, ``ly``,
``lx`` and the weights the bilinear ingredients of the sample's coordinate
(``ops/spg.py`` ``_sample_ingredients``: ``F.grid_sample``'s zeros padding).
Since row ``pid`` of the table holds the padded pixels of that patch, this
is ``m(rv, s)`` times the bilinear tap of ``table[view(rv), pid]``, where
``m`` counts the slots equal to ``pid`` (-1 pads never match).

``select_taps`` reads the packed table ``[V, P, (p+1)^2 * c]`` through the
slot ids and writes the taps into a channel range of a caller's
``[V, R, S, C]`` buffer. For CUDA tensors it builds the kernel from the
sources in the package (nvcc, at first use) and launches it, or raises; it
never falls back. For CPU tensors it takes the plain version,
``select_plain``: the contract reached the long way, through the gathered
``G`` (``gather_rows``) and the one-hot einsum ``select_taps_plain`` (the
JAX package's ``bspg._select_group_xla``).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from nerfool_tpu_torch.ops.build import load_library
from nerfool_tpu_torch.ops.spg import SPGSpec, _sample_ingredients

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SAMPLES = 256  # samples per thread block, as launched in the .cu source
_MAX_GRID_Y = 65535  # sample blocks per row
_MAX_SLOTS = 8192  # int32 slot ids beside the samples' 24 bytes, in 48 KB


@functools.lru_cache(maxsize=None)
def build():
    """Build ``csrc/bspg_select.cu`` (``ops/build.py``) and return its ctypes
    entry point."""
    fn = load_library("bspg_select").bspg_select
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def select_taps_plain(g, slots, pid, ly, lx, wy0, wy1, wx0, wx1, p, c):
    """The one-hot einsum form of the selection on gathered patch rows ``G``
    ``[n_rv, Ks, (p+1)^2 * c]``: slot-equality x row weights contracted with
    the patch rows, then the column weights. Rows run in batches that bound
    the one-hot operand at 2^26 elements.

    :return: [n_rv, ns, c] in G's dtype
    """
    n_rv, ks, _ = g.shape
    ns = pid.shape[1]
    p1 = p + 1
    out = torch.empty((n_rv, ns, c), dtype=g.dtype, device=g.device)
    step = max(1, (1 << 26) // max(1, ns * ks * p1))
    for r0 in range(0, n_rv, step):
        sl = slice(r0, min(n_rv, r0 + step))
        ly_, lx_ = ly[sl].long(), lx[sl].long()
        wy = (F.one_hot(ly_, p1) * wy0[sl, :, None]
              + F.one_hot(ly_ + 1, p1) * wy1[sl, :, None])  # [r, ns, p1]
        wx = (F.one_hot(lx_, p1) * wx0[sl, :, None]
              + F.one_hot(lx_ + 1, p1) * wx1[sl, :, None])
        eq = (pid[sl, :, None] == slots[sl, None, :]).to(torch.float32)
        w1 = (eq[..., None] * wy[..., None, :]).reshape(eq.shape[0], ns,
                                                        ks * p1)
        gk = g[sl].to(torch.float32).reshape(eq.shape[0], ks * p1, p1 * c)
        z = torch.bmm(w1, gk).reshape(eq.shape[0], ns, p1, c)
        out[sl] = torch.einsum("rsp,rspc->rsc", wx, z).to(g.dtype)
    return out


def gather_rows(table, slots, vi):
    """G: the table rows of every slot, ``[Vg, B, Ks, row]`` (pads read row
    0 and are never matched)."""
    idx = torch.clamp(slots, min=0).long() + (vi * table.shape[1])[:, None,
                                                                    None]
    return table.reshape(-1, table.shape[-1]).index_select(
        0, idx.reshape(-1)).reshape(slots.shape + (table.shape[-1],))


def select_plain(table, slots, vi, gx, gy, p, h, w, pbx):
    """The selection of one view group, the long way: G gathered, the
    ingredients of every sample, the one-hot einsum.

    :param vi: [Vg] int64 view indices of the group
    :return: [Vg, B, ns, c] in the table's dtype
    """
    vg, b, ks = slots.shape
    c = table.shape[-1] // (p + 1) ** 2
    ix = (gx[vi] + 1.0) * 0.5 * (w - 1)
    iy = (gy[vi] + 1.0) * 0.5 * (h - 1)
    ns = ix[0, 0].numel()
    geom = SPGSpec(p=p, h=h, w=w, h_full=h, w_full=w, pby=0, pbx=pbx,
                   groups=())
    ing = _sample_ingredients(ix.reshape(vg * b, ns), iy.reshape(vg * b, ns),
                              geom)
    f32 = torch.float32
    out = select_taps_plain(
        gather_rows(table, slots, vi).reshape(vg * b, ks, -1),
        slots.reshape(vg * b, ks), ing["pid"], ing["ly"], ing["lx"],
        ((1.0 - ing["fy"]) * ing["vy0"]).to(f32),
        (ing["fy"] * ing["vy1"]).to(f32),
        ((1.0 - ing["fx"]) * ing["vx0"]).to(f32),
        (ing["fx"] * ing["vx1"]).to(f32), p, c)
    return out.reshape(vg, b, ns, c)


def _check(table, slots, views, gx, gy, out, offset, p, h, w, pbx):
    if table.dim() != 3:
        raise ValueError(f"table must be [V, P, row], got {tuple(table.shape)}")
    v, n_patch, row = table.shape
    c = row // (p + 1) ** 2
    if row != (p + 1) ** 2 * c or c < 1:
        raise ValueError(f"table row {row} is not (p+1)^2 * c for p={p}")
    if slots.dim() != 3 or slots.shape[0] != len(views):
        raise ValueError(f"slots must be [Vg={len(views)}, B, Ks], got "
                         f"{tuple(slots.shape)}")
    if min(views) < 0 or max(views) >= v:
        raise ValueError(f"views {views} outside the table's {v}")
    b = slots.shape[1]
    if gx.dim() != 4 or gx.shape[:2] != (v, b) or gy.shape != gx.shape:
        raise ValueError(f"gx, gy must be [V={v}, B={b}, n, S], got "
                         f"{tuple(gx.shape)}, {tuple(gy.shape)}")
    rays, s = gx.shape[2], gx.shape[3]
    if out.dim() != 4 or out.shape[:3] != (v, b * rays, s):
        raise ValueError(f"out must be [V={v}, R={b * rays}, S={s}, C], got "
                         f"{tuple(out.shape)}")
    if not 0 <= offset <= out.shape[3] - c:
        raise ValueError(f"channels [{offset}, {offset + c}) outside out's "
                         f"{out.shape[3]}")
    if pbx < -(-(w + 1) // p) or n_patch < pbx * -(-(h + 1) // p):
        raise ValueError(f"a {h}x{w} grid in patches of {p} needs more than "
                         f"the table's {n_patch} rows of {pbx}")
    if table.dtype not in _DTYPES or out.dtype != table.dtype:
        raise ValueError(f"table dtype {table.dtype}, out {out.dtype} (both "
                         "float32 or both bfloat16)")
    if slots.dtype != torch.int32:
        raise ValueError(f"slots dtype {slots.dtype} != int32")
    if gx.dtype != torch.float32 or gy.dtype != torch.float32:
        raise ValueError(f"gx, gy dtype {gx.dtype}, {gy.dtype} != float32")
    devices = {t.device for t in (table, slots, gx, gy, out)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: "
                         f"{sorted(map(str, devices))}")


def _view_index(views, device):
    """Device index tensor of a view group. Consecutive views (the
    evaluator's one uniform group) come from ``arange`` on the device: a
    host-to-device copy of pageable memory would synchronize the stream
    once per chunk and stall the host's launch queue."""
    v0 = views[0]
    if tuple(views) == tuple(range(v0, v0 + len(views))):
        return torch.arange(v0, v0 + len(views), device=device)
    return torch.as_tensor(views, device=device)


def select_taps(table, slots, views, gx, gy, out, offset, p, h, w, pbx):
    """Selection of one view group on the tensors' device, written into
    ``out[views, :, :, offset:offset + c]``: the CUDA kernel for CUDA tensors
    (counted in ``select_taps.launches``), the plain version for CPU ones.

    :param table: [V, Pby*Pbx, (p+1)^2 * c] packed patch table (f32 or bf16)
    :param slots: [Vg, B, Ks] int32 slot lists of the group's views
    :param views: the group's view indices (a tuple of Vg ints)
    :param gx, gy: [V, B, n, S] f32 normalized sample coordinates of every
        view (block-major rays)
    :param out: [V, B*n, S, C] buffer in the table's dtype; only the group's
        views and the channels [offset, offset + c) are written
    :param p, h, w, pbx: patch size, sampled grid, patches per grid row
    """
    _check(table, slots, views, gx, gy, out, offset, p, h, w, pbx)
    vg, b, ks = slots.shape
    v, _, n, s = gx.shape
    c = table.shape[-1] // (p + 1) ** 2
    vi = _view_index(views, table.device)
    if table.device.type == "cpu":
        res = select_plain(table, slots, vi, gx, gy, p, h, w, pbx)
        out.view(v, b, n * s, -1)[vi, :, :, offset:offset + c] = res
        return out
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    for name, t in (("table", table), ("slots", slots), ("gx", gx),
                    ("gy", gy), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ns = n * s
    if ks > _MAX_SLOTS:
        raise ValueError(f"Ks={ks} slots exceed the kernel's {_MAX_SLOTS}")
    if -(-ns // _SAMPLES) > _MAX_GRID_Y:
        raise ValueError(f"{ns} samples per row exceed the kernel's grid")

    fn = build()
    vi32 = vi.to(torch.int32)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), slots.data_ptr(), vi32.data_ptr(),
                 gx.data_ptr(), gy.data_ptr(), out.data_ptr(), vg, b, ks, ns,
                 p, c, table.shape[1], pbx, h, w, out.shape[3], offset,
                 _DTYPES[table.dtype], stream)
    if err != 0:
        raise RuntimeError(f"bspg_select launch failed: cudaError {err}")
    select_taps.launches += 1
    return out


select_taps.launches = 0
