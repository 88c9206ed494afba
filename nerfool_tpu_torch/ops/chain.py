"""The whole-chain GNT aggregation, K2: the hand-written CUDA kernel
``csrc/gnt_chain.cu`` and its plain PyTorch version (port of
``nerfool_tpu/ops/chain_kernel.py``).

``gnt_chain(net, merged, emb)`` runs the ``depth`` view-transformer / q_fc /
ray-transformer blocks of ``net``, a ``GNTAggregator``, over every ray:

- ``merged`` ``[V, R, S, ci + 5]``: rgb_feat | ray_diff | mask, in the
  working dtype (float32 or bfloat16);
- ``emb`` ``[R, S, 126]``: the NeRF embeddings of the points and the view
  direction;
- returns ``q [R, S, D]`` before the final LayerNorm, and ``attn0 [R, S]``,
  the last ray attention's head-mean row of the first query, both in the
  working dtype.

``fused_chain_aggregate`` wraps it into a drop-in for ``GNTAggregator``:
embeddings, the chain, then the final LayerNorm / mean / ``rgb_fc`` head in
plain PyTorch. The plain version of the chain is the module's own
``GNTAggregator.chain``; ``gnt_chain`` takes it for CPU tensors only. For
CUDA tensors it builds the kernel (nvcc, at first use) and launches it, or
raises; it never falls back.
"""
from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from nerfool_tpu_torch.ops.build import load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# GNT's ray-attention heads and NeRF embedding width (3 coords, 10 bands);
# the kernel also fixes netwidth
_N_HEADS, _PE, _KERNEL_D = 4, 63, 64

# the per-depth kernel layout (csrc/gnt_chain.cu, VT_LN1 ... RA_F2B)
_LAYER_ORDER = (
    "vt_ln1", "vt_wq", "vt_wkv", "vt_p0", "vt_p0b", "vt_p1", "vt_p1b",
    "vt_a0", "vt_a0b", "vt_a1", "vt_a1b", "vt_wo", "vt_wob", "vt_ln2",
    "vt_f1", "vt_f1b", "vt_f2", "vt_f2b",
    "ra_ln1", "ra_wqkv_heads", "ra_wo", "ra_wob", "ra_ln2", "ra_f1",
    "ra_f1b", "ra_f2", "ra_f2b")


def _weight_version(net):
    """Changes whenever a parameter of ``net`` is replaced or written in
    place (``load_state_dict``, an optimizer step, ``.to()``)."""
    return tuple((p.data_ptr(), p._version) for p in net.parameters())


# net -> {(dtype, device): (weight version, blobs)}
_STACKS = weakref.WeakKeyDictionary()


def stack_weights(net, dtype):
    """The kernel's weights for ``net`` (a ``GNTAggregator``) in ``dtype``:
    (entry, layers, qfc) flat float32 tensors in the layout of
    ``csrc/gnt_chain.cu``, made once per net, dtype, device and weight
    version and then reused by every chunk.

    Each weight is rounded to ``dtype`` as the JAX package casts its params;
    ``Wk @ Wv`` is formed from the rounded factors in f32 and rounded once.
    """
    dev = net.rgb_fc.weight.device
    version = _weight_version(net)
    per_net = _STACKS.setdefault(net, {})
    hit = per_net.get((dtype, dev))
    if hit is not None and hit[0] == version:
        return hit[1]

    def rnd(x):
        return x.detach().to(dtype).float()

    def t(layer):  # Linear weight [out, in] -> rounded [in, out], f32
        return rnd(layer.weight.t())

    def b(layer):
        return rnd(layer.bias)

    def ln(norm):
        return rnd(torch.stack([norm.weight, norm.bias]))

    def stack(fn, mods):
        return torch.stack([fn(m) for m in mods])

    d, depth = net.netwidth, net.trans_depth
    vts = [m.attn for m in net.view_crosstrans]
    vblk = list(net.view_crosstrans)
    rts = [m.attn for m in net.view_selftrans]
    rblk = list(net.view_selftrans)
    qfs = [net.q_fcs[i] for i in range(0, depth, 2)]
    wk = stack(lambda a: t(a.k_fc), vts)
    wv = stack(lambda a: t(a.v_fc), vts)
    hd = d // _N_HEADS
    # ray attention qkv [depth, d, (q|k|v), head, hd] -> per head
    # [d, q_h | k_h | v_h]
    wqkv = stack(lambda a: torch.cat([t(a.q_fc), t(a.k_fc), t(a.v_fc)],
                                     dim=-1), rts)
    f = {
        "vt_ln1": stack(lambda m: ln(m.attn_norm), vblk),
        "vt_wq": stack(lambda a: t(a.q_fc), vts),
        "vt_wkv": torch.cat([wk, rnd(wk @ wv)], dim=-1),
        "vt_p0": stack(lambda a: t(a.pos_fc[0]), vts),
        "vt_p0b": stack(lambda a: b(a.pos_fc[0]), vts),
        "vt_p1": stack(lambda a: t(a.pos_fc[2]), vts),
        "vt_p1b": stack(lambda a: b(a.pos_fc[2]), vts),
        "vt_a0": stack(lambda a: t(a.attn_fc[0]), vts),
        "vt_a0b": stack(lambda a: b(a.attn_fc[0]), vts),
        "vt_a1": stack(lambda a: t(a.attn_fc[2]), vts),
        "vt_a1b": stack(lambda a: b(a.attn_fc[2]), vts),
        "vt_wo": stack(lambda a: t(a.out_fc), vts),
        "vt_wob": stack(lambda a: b(a.out_fc), vts),
        "vt_ln2": stack(lambda m: ln(m.ff_norm), vblk),
        "vt_f1": stack(lambda m: t(m.ff.fc1), vblk),
        "vt_f1b": stack(lambda m: b(m.ff.fc1), vblk),
        "vt_f2": stack(lambda m: t(m.ff.fc2), vblk),
        "vt_f2b": stack(lambda m: b(m.ff.fc2), vblk),
        "ra_ln1": stack(lambda m: ln(m.attn_norm), rblk),
        "ra_wqkv_heads": wqkv.reshape(depth, d, 3, _N_HEADS, hd).permute(
            0, 3, 1, 2, 4),
        "ra_wo": stack(lambda a: t(a.out_fc), rts),
        "ra_wob": stack(lambda a: b(a.out_fc), rts),
        "ra_ln2": stack(lambda m: ln(m.ff_norm), rblk),
        "ra_f1": stack(lambda m: t(m.ff.fc1), rblk),
        "ra_f1b": stack(lambda m: b(m.ff.fc1), rblk),
        "ra_f2": stack(lambda m: t(m.ff.fc2), rblk),
        "ra_f2b": stack(lambda m: b(m.ff.fc2), rblk),
    }
    layers = torch.cat([f[k].reshape(depth, -1) for k in _LAYER_ORDER], dim=1)
    e0w = t(net.rgbfeat_fc[0])
    ci = e0w.shape[0]
    e0 = torch.zeros((-(-ci // 4) * 4, d), device=dev)
    e0[:ci] = e0w
    entry = torch.cat([e0.reshape(-1), b(net.rgbfeat_fc[0]),
                       t(net.rgbfeat_fc[2]).reshape(-1),
                       b(net.rgbfeat_fc[2])])
    # q_fc input rows [q | pe | ve] -> [q | pe, 0 | ve, 0], 3d rows
    qf0 = stack(lambda m: t(m[0]), qfs)
    q0 = torch.zeros((len(qfs), 3 * d, d), device=dev)
    q0[:, :d] = qf0[:, :d]
    q0[:, d:d + _PE] = qf0[:, d:d + _PE]
    q0[:, 2 * d:2 * d + _PE] = qf0[:, d + _PE:]
    qfc = torch.cat([q0.reshape(len(qfs), -1),
                     stack(lambda m: b(m[0]), qfs),
                     stack(lambda m: t(m[2]), qfs).reshape(len(qfs), -1),
                     stack(lambda m: b(m[2]), qfs)], dim=1)
    blobs = (entry.contiguous(), layers.reshape(-1).contiguous(),
             qfc.reshape(-1).contiguous())
    per_net[(dtype, dev)] = (version, blobs)
    return blobs


def gnt_chain_plain(net, merged, emb):
    """The chain in plain PyTorch: ``net.chain`` on the kernel's operands,
    in ``merged``'s dtype (every product and LayerNorm rounds to it, as the
    TPU kernel's body does)."""
    ci = merged.shape[-1] - 5
    pe = emb.shape[-1] // 2
    return net.chain(merged[..., :ci], merged[..., ci:ci + 4],
                     merged[..., ci + 4:], emb[..., :pe], emb[..., pe:])


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("gnt_chain")
    lib.gnt_chain.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                              + [ctypes.c_void_p])
    lib.gnt_chain.restype = ctypes.c_int
    lib.gnt_chain_max_blocks.argtypes = [ctypes.c_int] * 4
    lib.gnt_chain_max_blocks.restype = ctypes.c_int
    lib.gnt_chain_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.gnt_chain_smem_bytes.restype = ctypes.c_longlong
    lib.gnt_chain_layout.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.gnt_chain_layout.restype = ctypes.c_int
    return lib


def build():
    """Build ``csrc/gnt_chain.cu`` (``ops/build.py``) and load it."""
    return _lib()


@functools.lru_cache(maxsize=None)
def _layout():
    layer, qfc = ctypes.c_int(), ctypes.c_int()
    _lib().gnt_chain_layout(ctypes.byref(layer), ctypes.byref(qfc))
    return layer.value, qfc.value


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index, v, s, ci, dtype_code):
    with torch.cuda.device(device_index):
        return _lib().gnt_chain_max_blocks(v, s, ci, dtype_code)


def _check(net, merged, emb):
    if merged.dim() != 4 or merged.shape[-1] < 6:
        raise ValueError(f"merged must be [V, R, S, ci + 5], got "
                         f"{tuple(merged.shape)}")
    v, r, s, _ = merged.shape
    if tuple(emb.shape[:2]) != (r, s) or emb.dim() != 3:
        raise ValueError(f"emb {tuple(emb.shape)} != [R, S, 2 * pe] with "
                         f"{(r, s)}")
    if merged.dtype not in _DTYPES or emb.dtype != merged.dtype:
        raise ValueError(f"dtypes {merged.dtype}/{emb.dtype} (float32 or "
                         "bfloat16, both the same)")
    ci = net.rgbfeat_fc[0].in_features
    if ci != merged.shape[-1] - 5:
        raise ValueError(f"merged has {merged.shape[-1] - 5} rgb_feat "
                         f"channels, the net takes {ci}")
    devices = {merged.device, emb.device, net.rgb_fc.weight.device}
    if len(devices) != 1:
        raise ValueError(f"inputs and net on several devices: "
                         f"{sorted(map(str, devices))}")


def gnt_chain(net, merged, emb):
    """The chain of ``net`` (a ``GNTAggregator``) on the tensors' device: the
    CUDA kernel for CUDA tensors (counted in ``gnt_chain.launches``), the
    plain version for CPU ones.

    :return: (q [R, S, D], attn0 [R, S]) in ``merged``'s dtype
    """
    _check(net, merged, emb)
    if merged.device.type == "cpu":
        return gnt_chain_plain(net, merged, emb)
    if merged.device.type != "cuda":
        raise ValueError(f"unsupported device {merged.device}")
    d, depth = net.netwidth, net.trans_depth
    if d != _KERNEL_D or emb.shape[-1] != 2 * _PE:
        raise ValueError(f"the kernel takes netwidth {_KERNEL_D} and "
                         f"{2 * _PE} embedding channels, got {d} and "
                         f"{emb.shape[-1]}")
    if depth < 1:
        raise ValueError("the kernel needs depth >= 1")
    for name, t in (("merged", merged), ("emb", emb)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    v, r, s, ctot = merged.shape
    code = _DTYPES[merged.dtype]
    dev = merged.device
    blocks = min(r, _max_blocks(dev.index if dev.index is not None
                                else torch.cuda.current_device(),
                                v, s, ctot - 5, code))
    if blocks < 1:
        raise ValueError(
            f"V={v}, S={s} needs {_lib().gnt_chain_smem_bytes(v, s, ctot - 5)}"
            " bytes of shared memory per block, more than the card offers")
    entry, layers, qfc = stack_weights(net, merged.dtype)
    layer_n, qfc_n = _layout()
    if layers.numel() != depth * layer_n or qfc.numel() != len(
            range(0, depth, 2)) * qfc_n:
        raise AssertionError(f"weight blobs of {layers.numel()}/{qfc.numel()}"
                             f" floats, the kernel reads {layer_n}/{qfc_n} per "
                             "block")
    xbuf = torch.empty((blocks, v, s, d), dtype=merged.dtype, device=dev)
    q = torch.empty((r, s, d), dtype=merged.dtype, device=dev)
    attn0 = torch.empty((r, s), dtype=merged.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().gnt_chain(
            merged.data_ptr(), emb.data_ptr(), entry.data_ptr(),
            layers.data_ptr(), qfc.data_ptr(), xbuf.data_ptr(), q.data_ptr(),
            attn0.data_ptr(), v, r, s, ctot - 5, depth, blocks, code,
            stream)
    if err != 0:
        raise RuntimeError(f"gnt_chain launch failed: cudaError {err}")
    gnt_chain.launches += 1
    return q, attn0


gnt_chain.launches = 0


def chain_inputs(net, rgb_feat, ray_diff, mask, pts, ray_d):
    """(merged, emb) for ``gnt_chain``, in ``rgb_feat``'s dtype."""
    dt = rgb_feat.dtype
    pts_emb, views_emb = net.embeddings(pts, ray_d)
    merged = torch.cat([rgb_feat, ray_diff.to(dt), mask.to(dt)], dim=-1)
    emb = torch.cat([pts_emb, views_emb], dim=-1).to(dt)
    return merged.contiguous(), emb.contiguous()


def fused_chain_aggregate(net, rgb_feat, ray_diff, mask, pts, ray_d):
    """Drop-in for ``net(rgb_feat, ray_diff, mask, pts, ray_d)`` (a
    ``GNTAggregator``) through the chain: [R, 3], or [R, 3 + S] under
    ``ret_alpha``, in ``rgb_feat``'s dtype."""
    q, attn0 = gnt_chain(net, *chain_inputs(net, rgb_feat, ray_diff, mask,
                                            pts, ray_d))
    return net.head(q, attn0)
