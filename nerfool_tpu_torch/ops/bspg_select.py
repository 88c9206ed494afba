"""BSPG tap selection: the hand-written CUDA kernel ``csrc/bspg_select.cu``
and its plain PyTorch version.

Contract, for each (view-row rv, sample s)::

    out[rv, s] = sum_{k : slots[rv, k] == pid[rv, s]}
                 sum_{dy in {0,1}, dx in {0,1}}
                 w_y[dy] * w_x[dx] * G[rv, k, (ly+dy)*(p+1) + (lx+dx), :]

with ``w_y = (wy0, wy1)`` and ``w_x = (wx0, wx1)``. ``G`` is
``[n_rv, Ks, (p+1)^2 * c]`` (patch rows in ``[dy, dx, c]`` order) in its table
dtype, f32 or bf16; weights are f32; the output is ``[n_rv, ns, c]`` in the
table dtype, accumulated in f32.

``select_taps`` takes the plain version for CPU tensors only. For CUDA
tensors it builds the kernel from the sources in the package (nvcc, at
first use) and launches it, or raises; it never falls back.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from nerfool_tpu_torch.ops.build import load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256  # threads per block, as launched in the .cu source
_MAX_GRID_Y = 65535
_MAX_SLOTS = 12288  # 48 KB of int32 slot ids in default shared memory


@functools.lru_cache(maxsize=None)
def build():
    """Build ``csrc/bspg_select.cu`` (``ops/build.py``) and return its ctypes
    entry point."""
    fn = load_library("bspg_select").bspg_select
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def select_taps_plain(g, slots, pid, ly, lx, wy0, wy1, wx0, wx1, p, c):
    """The one-hot einsum form of the selection (the JAX package's
    ``bspg._select_group_xla``): slot-equality x row weights contracted with
    the patch rows, then the column weights. Rows run in batches that bound
    the one-hot operand at 2^26 elements."""
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


def _check(g, slots, pid, ly, lx, wy0, wy1, wx0, wx1, p, c):
    if g.dim() != 3:
        raise ValueError(f"G must be [n_rv, Ks, row], got {tuple(g.shape)}")
    n_rv, ks, row = g.shape
    if row != (p + 1) ** 2 * c:
        raise ValueError(f"G row {row} != (p+1)^2 * c = {(p + 1) ** 2 * c}")
    if tuple(slots.shape) != (n_rv, ks):
        raise ValueError(f"slots {tuple(slots.shape)} != {(n_rv, ks)}")
    if pid.dim() != 2 or pid.shape[0] != n_rv:
        raise ValueError(f"pid must be [n_rv, ns], got {tuple(pid.shape)}")
    for name, t in (("ly", ly), ("lx", lx), ("wy0", wy0), ("wy1", wy1),
                    ("wx0", wx0), ("wx1", wx1)):
        if t.shape != pid.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != pid "
                             f"{tuple(pid.shape)}")
    if g.dtype not in _DTYPES:
        raise ValueError(f"G dtype {g.dtype} (float32 or bfloat16)")
    for name, t in (("slots", slots), ("pid", pid), ("ly", ly), ("lx", lx)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} dtype {t.dtype} != int32")
    for name, t in (("wy0", wy0), ("wy1", wy1), ("wx0", wx0), ("wx1", wx1)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} dtype {t.dtype} != float32")


def select_taps(g, slots, pid, ly, lx, wy0, wy1, wx0, wx1, p, c):
    """Selection on the tensors' device: the CUDA kernel for CUDA tensors
    (counted in ``select_taps.launches``), the plain version for CPU ones.

    :return: [n_rv, ns, c] in G's dtype
    """
    args = (g, slots, pid, ly, lx, wy0, wy1, wx0, wx1)
    _check(*args, p, c)
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    if g.device.type == "cpu":
        return select_taps_plain(*args, p, c)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    for name, t in zip(("g", "slots", "pid", "ly", "lx", "wy0", "wy1", "wx0",
                        "wx1"), args):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_rv, ks, _ = g.shape
    ns = pid.shape[1]
    if ks > _MAX_SLOTS:
        raise ValueError(f"Ks={ks} slots exceed the kernel's {_MAX_SLOTS}")
    if -(-ns * c // _THREADS) > _MAX_GRID_Y:
        raise ValueError(f"ns*c={ns * c} exceeds the kernel's grid")

    fn = build()
    out = torch.empty((n_rv, ns, c), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(*(t.data_ptr() for t in args), out.data_ptr(), n_rv, ks, ns,
                 p + 1, c, _DTYPES[g.dtype], stream)
    if err != 0:
        raise RuntimeError(f"bspg_select launch failed: cudaError {err}")
    select_taps.launches += 1
    return out


select_taps.launches = 0
