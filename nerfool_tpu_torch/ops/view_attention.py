"""GNT view attention, K4: the hand-written CUDA kernel of
``csrc/view_attention.cu``, its plain PyTorch version and the wrapper that
chooses between them by device (port of ``nerfool_tpu/ops/vt_kernel.py``:
``fused_view_attention`` and its lane-packed twin ``_fused_va_lp``).

``view_attention(qln, k, pos, mask, wq, wkv, wp0, bp0, wp1, bp1, wa0, ba0,
wa1, ba1, wo, bo)`` computes GNT's subtraction attention over the source
views in one pass, for N = rays x samples rows:

- ``qln`` ``[N, D]`` pre-LayerNormed query rows, ``k`` ``[V, N, D]`` per-view
  features, ``pos`` ``[V, N, 4]`` ray-difference encodings, ``mask``
  ``[V, N, 1]`` per-view validity; float32 or bfloat16;
- ``wq [D, D]``, ``wkv [D, 2D]`` (``Wk | Wk Wv``, formed by the caller),
  ``wp0 [4, D/8]``, ``wp1 [D/8, D]``, ``wa0 [D, D/8]``, ``wa1 [D/8, D]``,
  ``wo [D, D]`` (all in, out) and their biases;
- returns ``[N, D]``: ``qp = qln wq``; ``kp | vv = k wkv``; ``p = relu(pos
  wp0 + bp0) wp1 + bp1``; ``a = relu((kp - qp + p) wa0 + ba0) wa1 + ba1``,
  ``-1e9`` where ``mask == 0``; a softmax over the views per channel;
  ``(sum_v (vv + p) w) wo + bo``.

Forward only, as the TPU kernel: it raises when autograd would need a
gradient through it (the attack differentiates the module path). CUDA tensors
go through the kernel (built by nvcc at first use) or raise; CPU tensors take
``view_attention_plain``. Nothing falls back from the kernel to the plain
version. ``lane_pack`` selects the TPU kernel's lane-packed formulation,
which computes the same function: both map to the one CUDA kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from nerfool_tpu_torch.ops.build import load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WEIGHTS = ("wq", "wkv", "wp0", "bp0", "wp1", "bp1", "wa0", "ba0", "wa1",
            "ba1", "wo", "bo")


def view_attention_plain(qln, k, pos, mask, wq, wkv, wp0, bp0, wp1, bp1, wa0,
                         ba0, wa1, ba1, wo, bo):
    """The function in plain PyTorch, every product in ``k``'s dtype with
    the weights cast to it: GNT's module path (``ViewAttention.forward``
    calls it, with any leading shape in place of N, under autograd too).

    :return: [N, D]
    """
    dt = k.dtype
    d = qln.shape[-1]
    (wq, wkv, wp0, bp0, wp1, bp1, wa0, ba0, wa1, ba1, wo, bo) = (
        w.to(dt) for w in (wq, wkv, wp0, bp0, wp1, bp1, wa0, ba0, wa1, ba1,
                           wo, bo))
    qp = qln @ wq
    kv = k @ wkv
    kp, vv = kv[..., :d], kv[..., d:]
    # F.linear takes [out, in]: the biased products keep their fused bias
    lin = lambda x, w, b: F.linear(x, w.t(), b)
    p = lin(torch.relu(lin(pos, wp0, bp0)), wp1, bp1)
    a = lin(torch.relu(lin(kp - qp[None] + p, wa0, ba0)), wa1, ba1)
    a = a.masked_fill(mask == 0, -1e9)
    w = torch.softmax(a, dim=0)  # over the views, per channel
    return lin(torch.sum((vv + p) * w, dim=0), wo, bo)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("view_attention")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.view_attention_fwd.argtypes = [vp] * 6 + [ci] * 4 + [vp]
    lib.view_attention_fwd.restype = ci
    lib.view_attention_max_blocks.argtypes = [ci]
    lib.view_attention_max_blocks.restype = ci
    lib.view_attention_dims.argtypes = [ctypes.POINTER(ci)] * 5
    lib.view_attention_dims.restype = ci
    return lib


def build():
    """Build ``csrc/view_attention.cu`` (``ops/build.py``) and load it."""
    return _lib()


@functools.lru_cache(maxsize=None)
def _kernel_dims():
    """(D, hidden, pos width, rows per tile, floats of the weight blob)"""
    vals = [ctypes.c_int() for _ in range(5)]
    _lib().view_attention_dims(*(ctypes.byref(v) for v in vals))
    return tuple(v.value for v in vals)


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index, dtype_code):
    with torch.cuda.device(device_index):
        return _lib().view_attention_max_blocks(dtype_code)


def _check(qln, k, pos, mask, weights):
    if qln.dim() != 2 or k.dim() != 3:
        raise ValueError(f"qln must be [N, D] and k [V, N, D], got "
                         f"{tuple(qln.shape)} and {tuple(k.shape)}")
    n, d = qln.shape
    v = k.shape[0]
    if d % 8:
        raise ValueError(f"D={d} is not a multiple of 8")
    pd = pos.shape[-1]
    want = {"k": (v, n, d), "pos": (v, n, pd), "mask": (v, n, 1),
            "wq": (d, d), "wkv": (d, 2 * d), "wp0": (pd, d // 8),
            "bp0": (d // 8,), "wp1": (d // 8, d), "bp1": (d,),
            "wa0": (d, d // 8), "ba0": (d // 8,), "wa1": (d // 8, d),
            "ba1": (d,), "wo": (d, d), "bo": (d,)}
    got = dict(k=k, pos=pos, mask=mask, **dict(zip(_WEIGHTS, weights)))
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} {tuple(got[name].shape)} != {shape}")
    for name, t in (("k", k), ("pos", pos), ("mask", mask)):
        if t.dtype != qln.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != qln's {qln.dtype}")
    devices = {t.device for t in (qln, *got.values())}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: "
                         f"{sorted(map(str, devices))}")


def _aligned(t):
    """``t`` contiguous at a 16-byte aligned address (the kernel's vector
    loads)."""
    t = t.detach().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _weight_blob(dtype, wq, wkv, wp0, bp0, wp1, bp1, wa0, ba0, wa1, ba1, wo,
                 bo):
    """The weights rounded to ``dtype`` as the module path casts them, in
    one f32 blob in the kernel's order (``wa0`` transposed)."""
    order = (wkv, wq, wo, wp0, bp0, wp1, bp1, wa0.t(), ba0, wa1, ba1, bo)
    return torch.cat([w.detach().to(dtype).float().reshape(-1)
                      for w in order])


def view_attention(qln, k, pos, mask, wq, wkv, wp0, bp0, wp1, bp1, wa0, ba0,
                   wa1, ba1, wo, bo, lane_pack=False):
    """The view attention on ``k``'s device (see the module docstring): the
    CUDA kernel for CUDA tensors (counted in ``view_attention.launches``),
    the plain version for CPU ones. Forward only: raises ``RuntimeError``
    when grad mode is on and an operand requires grad.

    :param lane_pack: the TPU kernel's lane-packed formulation, the same
        function; accepted and ignored
    :return: [N, D] in ``qln``'s dtype
    """
    weights = (wq, wkv, wp0, bp0, wp1, bp1, wa0, ba0, wa1, ba1, wo, bo)
    _check(qln, k, pos, mask, weights)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (qln, k, pos, mask, *weights)):
        raise RuntimeError(
            "view_attention is forward only (no backward kernel): call it "
            "under torch.no_grad(), or keep the module path "
            "(fused_vt=False) where a gradient is needed")
    if k.device.type == "cpu":
        return view_attention_plain(qln, k, pos, mask, *weights)
    if k.device.type != "cuda":
        raise ValueError(f"unsupported device {k.device}")
    if qln.dtype not in _DTYPES:
        raise ValueError(f"dtype {qln.dtype} (float32 or bfloat16)")
    n, d = qln.shape
    v = k.shape[0]
    kd, khid, kpd, tile_rows, w_floats = _kernel_dims()
    if (d, pos.shape[-1]) != (kd, kpd):
        raise ValueError(f"the kernel takes D, pos width = {(kd, kpd)}, got "
                         f"{(d, pos.shape[-1])}")
    dev = k.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    code = _DTYPES[qln.dtype]
    blocks = min(-(-n // tile_rows), _max_blocks(index, code))
    if blocks < 1:
        raise RuntimeError("view_attention: one block does not fit the card")
    blob = _weight_blob(qln.dtype, *weights)
    if blob.numel() != w_floats:
        raise RuntimeError(f"weight blob of {blob.numel()} floats, the "
                           f"kernel takes {w_floats}")
    qln, k, pos, mask = (_aligned(t) for t in (qln, k, pos, mask))
    out = torch.empty_like(qln)
    with torch.cuda.device(dev):
        err = _lib().view_attention_fwd(
            qln.data_ptr(), k.data_ptr(), pos.data_ptr(), mask.data_ptr(),
            blob.data_ptr(), out.data_ptr(), v, n, blocks, code,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"view_attention launch failed: cudaError {err}")
    view_attention.launches += 1
    return out


view_attention.launches = 0
