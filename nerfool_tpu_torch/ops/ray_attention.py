"""GNT ray attention, K3: the hand-written CUDA kernels of
``csrc/ray_attention.cu`` (forward and backward), their plain PyTorch
versions, and the ``torch.autograd.Function`` that joins them (port of
``nerfool_tpu/ops/ra_kernel.py``: ``fused_ray_attention``, ``_ra_bwd`` and
the custom VJP ``fused_ray_attention_ad``).

``ray_attention(x, wqkv, wo, bo, n_heads)`` computes, per ray, the multi-head
self-attention along the samples:

- ``x`` ``[R, S, D]`` pre-LayerNormed rows, float32 or bfloat16;
- ``wqkv`` ``[D, 3D]`` the q | k | v projection (in, out), ``wo`` ``[D, D]``
  and ``bo`` ``[D]`` the output projection;
- returns ``out [R, S, D]`` (attention output after ``wo``, ``bo``) and
  ``attn0 [R, S]``, the mean over heads of the softmax row of query 0 (GNT's
  compositing weights), both in ``x``'s dtype.

It is differentiable in every tensor argument. The forward saves only ``x``
and the weights; the backward recomputes qkv and the softmax, so no
``[R, H, S, S]`` map is kept for autograd, on either route.

CUDA tensors go through the kernels (built by nvcc at first use) or raise;
CPU tensors take ``ray_attention_plain`` and ``ray_attention_bwd_plain``,
which write out the same formulas in tensor ops. Nothing falls back from the
kernel to the plain version. Both kernels run their products on the tensor
cores, float32 as three TF32 products; the weights are packed on the card
as B fragments, in the layout of ``pack_b_tf32`` of
``ops/view_attention.py`` (Wqkv and Wo for the forward, Wo^T and Wqkv^T
besides for the backward), once for each value of the weights: the packed
copy is kept while the tensors passed in keep their storage and version
counter (a write through ``.data``, which bypasses that counter, is not
seen). With weight gradients the backward kernel also sums them, per block
of the grid, and the wrapper adds the blocks' partial sums in one ordered
sum.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from nerfool_tpu_torch.ops.build import load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _heads(t, n_heads):
    """[R, S, H * hd] -> [R, H, S, hd]"""
    r, s, d = t.shape
    return t.reshape(r, s, n_heads, d // n_heads).transpose(1, 2)


def _merge(t):
    """[R, H, S, hd] -> [R, S, H * hd]"""
    r, h, s, hd = t.shape
    return t.transpose(1, 2).reshape(r, s, h * hd)


def _probs(x, wqkv, n_heads):
    """q, k, v [R, H, S, hd] and the softmax map [R, H, S, S], every product
    in ``x``'s dtype."""
    d = x.shape[-1]
    qkv = x @ wqkv
    q, k, v = (_heads(qkv[..., i * d:(i + 1) * d], n_heads) for i in range(3))
    scale = 1.0 / math.sqrt(d // n_heads)
    return q, k, v, torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)


def ray_attention_plain(x, wqkv, wo, bo, n_heads=4):
    """The forward in plain PyTorch, every product rounded to ``x``'s dtype
    as the module path rounds it.

    :return: (out [R, S, D], attn0 [R, S])
    """
    dt = x.dtype
    _, _, v, p = _probs(x, wqkv.to(dt), n_heads)
    out = _merge(p @ v) @ wo.to(dt) + bo.to(dt)
    return out, torch.mean(p[:, :, 0], dim=1)


def ray_attention_bwd_plain(x, wqkv, wo, gout, gattn0, n_heads=4):
    """The backward in plain PyTorch, with the backward kernel's formulas:
    recompute qkv and the softmax ``p``; ``dp = go v^T`` with ``gattn0 /
    n_heads`` added on query row 0; ``ds = p (dp - sum_k dp p) / sqrt(hd)``;
    ``dq = ds k``, ``dk = ds^T q``, ``dv = p^T go``; ``dx = gqkv wqkv^T``.

    :return: (dx [R, S, D] in ``x``'s dtype, dwqkv [D, 3D] and dwo [D, D]
        in float32, or float64 for float64 inputs)
    """
    dt = x.dtype
    d = x.shape[-1]
    wqkv, wo = wqkv.to(dt), wo.to(dt)
    gout, gattn0 = gout.to(dt), gattn0.to(dt)
    scale = 1.0 / math.sqrt(d // n_heads)
    q, k, v, p = _probs(x, wqkv, n_heads)
    cat = _merge(p @ v)
    go = _heads(gout @ wo.t(), n_heads)
    dp = go @ v.transpose(-1, -2)
    dp[:, :, 0] += (gattn0 / n_heads)[:, None, :]
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True)) * scale
    gqkv = torch.cat([_merge(ds @ k), _merge(ds.transpose(-1, -2) @ q),
                      _merge(p.transpose(-1, -2) @ go)], dim=-1)
    dx = gqkv @ wqkv.t()
    acc = torch.promote_types(dt, torch.float32)  # weight sums in >= f32
    dwqkv = x.reshape(-1, d).to(acc).t() @ gqkv.reshape(-1, 3 * d).to(acc)
    dwo = cat.reshape(-1, d).to(acc).t() @ gout.reshape(-1, d).to(acc)
    return dx, dwqkv, dwo


def bind(lib):
    """Declare the C entries' signatures on a loaded build of the source."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ray_attention_fwd.argtypes = [vp] * 6 + [ci] * 4 + [vp]
    lib.ray_attention_fwd.restype = ci
    lib.ray_attention_bwd.argtypes = [vp] * 6 + [ci] * 4 + [vp]
    lib.ray_attention_bwd.restype = ci
    lib.ray_attention_max_blocks.argtypes = [ci] * 3
    lib.ray_attention_max_blocks.restype = ci
    lib.ray_attention_smem_bytes.argtypes = [ci] * 2
    lib.ray_attention_smem_bytes.restype = ctypes.c_longlong
    lib.ray_attention_dims.argtypes = [ctypes.POINTER(ci)] * 2
    lib.ray_attention_dims.restype = ci
    lib.ray_attention_resources.argtypes = [ci] * 2 + [ctypes.POINTER(ci)] * 3
    lib.ray_attention_resources.restype = ci
    lib.ray_attention_pack_weights.argtypes = [vp] * 4
    lib.ray_attention_pack_weights.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    return bind(load_library("ray_attention"))


def build():
    """Build ``csrc/ray_attention.cu`` (``ops/build.py``) and load it."""
    return _lib()


@functools.lru_cache(maxsize=None)
def _kernel_dims():
    d, nh = ctypes.c_int(), ctypes.c_int()
    _lib().ray_attention_dims(ctypes.byref(d), ctypes.byref(nh))
    return d.value, nh.value


@functools.lru_cache(maxsize=None)
def _max_blocks(lib, device_index, s, backward, dtype_code):
    with torch.cuda.device(device_index):
        return lib.ray_attention_max_blocks(s, backward, dtype_code)


def kernel_resources(s, dtype=torch.float32, backward=False, want_dw=False):
    """What the built forward (or backward, with the weight gradients or
    not) kernel takes on the current card at ``s`` samples: registers per
    thread, threads per block, spilled bytes per thread, dynamic shared
    memory per block and blocks resident on the card."""
    lib = _lib()
    code, bwd = _DTYPES[dtype], (2 if want_dw else 1) if backward else 0
    regs, threads, local = (ctypes.c_int() for _ in range(3))
    err = lib.ray_attention_resources(bwd, code, *(ctypes.byref(v) for v in
                                                   (regs, threads, local)))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {err}")
    return dict(registers=regs.value, threads=threads.value,
                spill_bytes=local.value,
                smem_bytes=lib.ray_attention_smem_bytes(s, bwd),
                blocks=_max_blocks(lib, torch.cuda.current_device(), s, bwd,
                                   code))


def _check(x, wqkv, wo, n_heads, **same_shape):
    if x.dim() != 3:
        raise ValueError(f"x must be [R, S, D], got {tuple(x.shape)}")
    d = x.shape[-1]
    if tuple(wqkv.shape) != (d, 3 * d) or tuple(wo.shape) != (d, d):
        raise ValueError(f"wqkv {tuple(wqkv.shape)} / wo {tuple(wo.shape)} "
                         f"!= [{d}, {3 * d}] / [{d}, {d}]")
    if d % n_heads:
        raise ValueError(f"D={d} is not a multiple of n_heads={n_heads}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"dtype {x.dtype} (float32 or bfloat16)")
    for name, (t, shape) in same_shape.items():
        if tuple(t.shape) != shape or t.dtype != x.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} != "
                             f"{shape} {x.dtype}")
    devices = {x.device, wqkv.device, wo.device,
               *(t.device for t, _ in same_shape.values())}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: "
                         f"{sorted(map(str, devices))}")


def _blocks(x, n_heads, backward, lib=None):
    """Persistent grid size for ``x`` on its CUDA device, or raise where the
    kernel does not take the shape. ``backward``: 0 the forward kernel, 1
    the backward, 2 the backward with the weight gradients."""
    lib = lib or _lib()
    r, s, d = x.shape
    if (d, n_heads) != _kernel_dims():
        raise ValueError(f"the kernel takes D, n_heads = {_kernel_dims()}, "
                         f"got {(d, n_heads)}")
    dev = x.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    blocks = min(r, _max_blocks(lib, index, s, backward, _DTYPES[x.dtype]))
    if blocks < 1:
        kernel = ("forward", "backward",
                  "backward (with the weight gradients)")[backward]
        raise ValueError(
            f"R={r}, S={s} needs {lib.ray_attention_smem_bytes(s, backward)}"
            f" bytes of shared memory per block of the {kernel} kernel, more "
            "than the card offers")
    return blocks


def _aligned(t):
    """``t``, copied where its storage is not 16-byte aligned (the kernels'
    8-byte loads of rows)."""
    return t.clone() if t.data_ptr() % 16 else t


def _weight(w, dtype):
    """``w`` rounded to ``dtype`` as the module path casts it, in f32."""
    return w.detach().to(dtype).float()


def ray_attention_fwd(x, wqkv, wo, bo, n_heads=4):
    """The forward on ``x``'s device, without autograd: the CUDA kernel for
    CUDA tensors (counted in ``ray_attention_fwd.launches``), the plain
    version for CPU ones.

    :return: (out [R, S, D], attn0 [R, S]) in ``x``'s dtype
    """
    _check(x, wqkv, wo, n_heads)
    if tuple(bo.shape) != (x.shape[-1],) or bo.device != x.device:
        raise ValueError(f"bo {tuple(bo.shape)} on {bo.device} != "
                         f"[{x.shape[-1]}] on {x.device}")
    if x.device.type == "cpu":
        return ray_attention_plain(x, wqkv, wo, bo, n_heads)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out, attn0 = launch_fwd(_lib(), x, wqkv, wo, bo, n_heads,
                            _packed(wqkv, wo, x.dtype))
    ray_attention_fwd.launches += 1
    return out, attn0


ray_attention_fwd.launches = 0


def launch_fwd(lib, x, wqkv, wo, bo, n_heads=4, wpack=None):
    """One launch of the forward kernel of ``lib``, a loaded build of
    ``csrc/ray_attention.cu`` after ``bind`` (``ray_attention_fwd`` passes
    the package's own; a profiler may pass a build with other flags), on
    CUDA tensors checked by the caller, uncounted. ``wpack``: the weights as
    ``pack_weights`` packs them; None packs them for this launch.

    :return: (out [R, S, D], attn0 [R, S]) in ``x``'s dtype
    """
    blocks = _blocks(x, n_heads, 0, lib)
    r, s, d = x.shape
    x = _aligned(x.detach().contiguous())
    if wpack is None:
        wpack = pack_weights(lib, wqkv, wo, x.dtype)
    b2 = _weight(bo, x.dtype).contiguous()
    out = torch.empty_like(x)
    attn0 = torch.empty((r, s), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ray_attention_fwd(
            x.data_ptr(), wpack.data_ptr(),
            wpack[2 * d * 3 * d:].data_ptr(), b2.data_ptr(), out.data_ptr(),
            attn0.data_ptr(), r, s, blocks, _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ray_attention_fwd launch failed: cudaError {err}")
    return out, attn0


def pack_weights(lib, wqkv, wo, dtype):
    """The kernels' B fragments of ``wqkv`` and ``wo`` (rounded to ``dtype``
    as the module path casts them), packed on the card by the library's
    pack kernel in ``pack_b_tf32``'s layout: ``[4 D 4D]`` f32, packed Wqkv
    and Wo (the forward's), then Wo^T and Wqkv^T (the backward's). Raises
    where the weights are not of the width the kernel was built for (the
    pack kernel reads that layout)."""
    d = _kernel_dims()[0]
    if tuple(wqkv.shape) != (d, 3 * d) or tuple(wo.shape) != (d, d):
        raise ValueError(f"the kernel takes D, n_heads = {_kernel_dims()}: "
                         f"wqkv {tuple(wqkv.shape)}, wo {tuple(wo.shape)}")
    w1 = _weight(wqkv, dtype).contiguous()
    w2 = _weight(wo, dtype).contiguous()
    wpack = torch.empty(4 * d * 4 * d, dtype=torch.float32, device=w1.device)
    with torch.cuda.device(w1.device):
        err = lib.ray_attention_pack_weights(
            w1.data_ptr(), w2.data_ptr(), wpack.data_ptr(),
            torch.cuda.current_stream(w1.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ray_attention_pack_weights failed: cudaError "
                           f"{err}")
    return wpack


# the packed weights of the last few (wqkv, wo, dtype), newest last: key ->
# (wqkv, wo, packed). The entry holds both tensors, so their storage, and so
# their address, stays theirs while it lives; with the version counters in
# the key an entry is found only for the same values.
_PACKED = collections.OrderedDict()
_PACKED_MAX = 32


def _packed(wqkv, wo, dtype):
    """``pack_weights`` of the package's build, packed once for each value
    of ``wqkv`` and ``wo`` (inference tensors, which keep no version
    counter, are packed at every call)."""
    if wqkv.is_inference() or wo.is_inference():
        return pack_weights(_lib(), wqkv, wo, dtype)
    key = (dtype, *((w.data_ptr(), w._version, w.dtype, w.device,
                     tuple(w.shape), w.stride()) for w in (wqkv, wo)))
    entry = _PACKED.pop(key, None)
    if entry is None:
        with torch.inference_mode(False), torch.no_grad():
            entry = (wqkv.detach(), wo.detach(),
                     pack_weights(_lib(), wqkv, wo, dtype))
    _PACKED[key] = entry
    if len(_PACKED) > _PACKED_MAX:
        _PACKED.popitem(last=False)
    return entry[2]


def ray_attention_bwd(x, wqkv, wo, gout, gattn0, n_heads=4, want_dw=True):
    """The backward on ``x``'s device: the CUDA kernel for CUDA tensors
    (counted in ``ray_attention_bwd.launches``, and those with the weight
    gradients in ``ray_attention_bwd.dw_launches`` too), the plain version
    for CPU ones. ``want_dw=False`` skips the weight gradients (an attack
    freezes the weights) and returns None for them.

    :return: (dx [R, S, D] in ``x``'s dtype, dwqkv [D, 3D], dwo [D, D] in
        float32)
    """
    r, s, d = x.shape if x.dim() == 3 else (0, 0, 0)
    _check(x, wqkv, wo, n_heads, gout=(gout, (r, s, d)),
           gattn0=(gattn0, (r, s)))
    if x.device.type == "cpu":
        dx, dwqkv, dwo = ray_attention_bwd_plain(x, wqkv, wo, gout, gattn0,
                                                 n_heads)
        return (dx, dwqkv, dwo) if want_dw else (dx, None, None)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = launch_bwd(_lib(), x, wqkv, wo, gout, gattn0, n_heads, want_dw,
                     _packed(wqkv, wo, x.dtype))
    ray_attention_bwd.launches += 1
    ray_attention_bwd.dw_launches += bool(want_dw)
    return out


def launch_bwd(lib, x, wqkv, wo, gout, gattn0, n_heads=4, want_dw=False,
               wpack=None):
    """One launch of the backward kernel of ``lib`` (as ``launch_fwd``), on
    CUDA tensors checked by the caller, uncounted. ``wpack``: the weights as
    ``pack_weights`` packs them; None packs them for this launch.

    :return: (dx [R, S, D] in ``x``'s dtype, and with ``want_dw`` dwqkv [D,
        3D] and dwo [D, D] in f32, else None, None)
    """
    blocks = _blocks(x, n_heads, 2 if want_dw else 1, lib)
    r, s, d = x.shape
    x, gout, gattn0 = (_aligned(t.detach().contiguous())
                       for t in (x, gout, gattn0))
    if wpack is None:
        wpack = pack_weights(lib, wqkv, wo, x.dtype)
    dx = torch.empty_like(x)
    # the blocks' partial sums of dWqkv [D, 3D] and dWo [D, D], one row each
    dwp = (torch.zeros((blocks, 4 * d * d), dtype=torch.float32,
                       device=x.device) if want_dw else None)
    with torch.cuda.device(x.device):
        err = lib.ray_attention_bwd(
            x.data_ptr(), wpack.data_ptr(), gout.data_ptr(),
            gattn0.data_ptr(), dx.data_ptr(),
            dwp.data_ptr() if want_dw else None, r, s, blocks,
            _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ray_attention_bwd launch failed: cudaError {err}")
    if not want_dw:
        return dx, None, None
    # one ordered sum over the blocks' partials: deterministic
    dw = torch.sum(dwp, dim=0)
    return dx, dw[:3 * d * d].view(d, 3 * d), dw[3 * d * d:].view(d, d)


ray_attention_bwd.launches = 0
ray_attention_bwd.dw_launches = 0


class _RayAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, wo, bo, n_heads):
        ctx.save_for_backward(x, wqkv, wo)
        ctx.n_heads = n_heads
        ctx.bo_dtype = bo.dtype
        return ray_attention_fwd(x, wqkv, wo, bo, n_heads)

    @staticmethod
    def backward(ctx, gout, gattn0):
        x, wqkv, wo = ctx.saved_tensors
        _, need_wqkv, need_wo, need_bo, _ = ctx.needs_input_grad
        gout, gattn0 = gout.to(x.dtype), gattn0.to(x.dtype)
        dx, dwqkv, dwo = ray_attention_bwd(
            x, wqkv, wo, gout, gattn0, ctx.n_heads,
            want_dw=need_wqkv or need_wo)
        dbo = (torch.sum(gout, dim=(0, 1), dtype=torch.float32).to(
            ctx.bo_dtype) if need_bo else None)
        return (dx, dwqkv.to(wqkv.dtype) if need_wqkv else None,
                dwo.to(wo.dtype) if need_wo else None, dbo, None)


def ray_attention(x, wqkv, wo, bo, n_heads=4):
    """Differentiable ray attention (see the module docstring): the kernels
    in both directions for CUDA tensors, the plain versions for CPU ones.

    :return: (out [R, S, D], attn0 [R, S]) in ``x``'s dtype
    """
    return _RayAttention.apply(x, wqkv, wo, bo, n_heads)
