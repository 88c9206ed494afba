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
version.
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
    lib.view_attention_fwd.argtypes = [vp] * 7 + [ci] * 4 + [vp]
    lib.view_attention_fwd.restype = ci
    lib.view_attention_max_blocks.argtypes = [ci]
    lib.view_attention_max_blocks.restype = ci
    lib.view_attention_dims.argtypes = [ci] + [ctypes.POINTER(ci)] * 6
    lib.view_attention_dims.restype = ci
    return lib


def build():
    """Build ``csrc/view_attention.cu`` (``ops/build.py``) and load it."""
    return _lib()


@functools.lru_cache(maxsize=None)
def _kernel_dims(dtype_code):
    """(D, hidden, pos width, rows per block step, 32-bit words of the packed
    matrices, floats of the vector blob) of the dtype's kernel"""
    vals = [ctypes.c_int() for _ in range(6)]
    _lib().view_attention_dims(dtype_code,
                               *(ctypes.byref(v) for v in vals))
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


def tf32_round(x):
    """f32 ``x`` rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero) as ``cvt.rna.tf32.f32`` rounds it, kept as float32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x):
    """(hi, lo): ``hi = tf32(x)``, ``lo = tf32(x - hi)``; ``hi + lo`` holds
    ``x`` to ~2^-22 of its magnitude."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def pack_b_tf32(w):
    """``w [K, N]`` (in, out; K and N multiples of 8) as the B fragments of
    the kernel's three-product ``mma.sync.m16n8k8`` TF32 products: ``[K/8,
    N/8, 32, 4]`` f32 where lane ``4 g + t`` of fragment ``(kt, nt)`` holds
    hi and lo of ``w[8 kt + 2 t, 8 nt + g]`` and ``w[8 kt + 2 t + 1, 8 nt +
    g]`` as (hi0, hi1, lo0, lo1): one 16-byte load per lane. The k index is
    permuted (logical rows t and t + 4 of the step are rows 2 t and 2 t + 1)
    so that the A fragments are pairs of neighbouring channels. Flattened:
    ``[2 K N]``."""
    k, n = w.shape
    if k % 8 or n % 8:
        raise ValueError(f"K={k}, N={n} are not multiples of 8")
    hi, lo = tf32_split(w)
    # k = 8 kt + 2 t + e, n = 8 nt + g -> [kt, nt, g, t, (hi, lo), e]
    parts = torch.stack([x.reshape(k // 8, 4, 2, n // 8, 8)
                         for x in (hi, lo)], dim=-1)  # [kt, t, e, nt, g, h]
    return parts.permute(0, 3, 4, 1, 5, 2).reshape(-1)


def weight_blobs(dtype, wq, wkv, wp0, bp0, wp1, bp1, wa0, ba0, wa1, ba1, wo,
                 bo):
    """The weights rounded to ``dtype`` as the module path casts them, in
    the kernel's two blobs: the matrices ``Wk | Wk Wv``, ``Wq``, ``Wo``
    packed as B fragments (float32: ``pack_b_tf32``; bfloat16:
    ``ops/chain.py`` ``pack_b``), and the rest as one f32 vector blob in the
    kernel's order (``wa0`` transposed)."""
    from nerfool_tpu_torch.ops.chain import pack_b

    r = lambda w: w.detach().to(dtype).float()
    mats = [r(w) for w in (wkv, wq, wo)]
    if dtype == torch.float32:
        mats = torch.cat([pack_b_tf32(w) for w in mats])
    else:
        mats = torch.cat([pack_b(w.to(dtype)) for w in mats])
    vecs = torch.cat([r(w).reshape(-1) for w in (
        wp0, bp0, wp1, bp1, wa0.t(), ba0, wa1, ba1, bo)])
    return mats.contiguous(), vecs


def view_attention(qln, k, pos, mask, wq, wkv, wp0, bp0, wp1, bp1, wa0, ba0,
                   wa1, ba1, wo, bo):
    """The view attention on ``k``'s device (see the module docstring): the
    CUDA kernel for CUDA tensors (counted in ``view_attention.launches``),
    the plain version for CPU ones. Forward only: raises ``RuntimeError``
    when grad mode is on and an operand requires grad.

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
    code = _DTYPES[qln.dtype]
    kd, khid, kpd, block_rows, mat_words, vec_floats = _kernel_dims(code)
    if (d, pos.shape[-1]) != (kd, kpd):
        raise ValueError(f"the kernel takes D, pos width = {(kd, kpd)}, got "
                         f"{(d, pos.shape[-1])}")
    dev = k.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    blocks = min(-(-n // block_rows), _max_blocks(index, code))
    if blocks < 1:
        raise RuntimeError("view_attention: one block does not fit the card")
    mats, vecs = weight_blobs(qln.dtype, *weights)
    words = mats.numel() * mats.element_size() // 4
    if (words, vecs.numel()) != (mat_words, vec_floats):
        raise RuntimeError(f"weight blobs of {words} words and "
                           f"{vecs.numel()} floats, the kernel takes "
                           f"{mat_words} and {vec_floats}")
    qln, k, pos, mask = (_aligned(t) for t in (qln, k, pos, mask))
    out = torch.empty_like(qln)
    with torch.cuda.device(dev):
        err = _lib().view_attention_fwd(
            qln.data_ptr(), k.data_ptr(), pos.data_ptr(), mask.data_ptr(),
            mats.data_ptr(), vecs.data_ptr(), out.data_ptr(), v, n, blocks,
            code, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"view_attention launch failed: cudaError {err}")
    view_attention.launches += 1
    return out


view_attention.launches = 0
