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
CUDA tensors it builds the source (nvcc, at first use) and launches one of
its two kernels, or raises; it never falls back. bfloat16 tensors take the
tensor-core kernel (``mma.sync``; ``stack_weights`` packs the matrices as
the instruction's B fragments, ``pack_b``), float32 tensors the exact-f32
kernel on the CUDA cores.
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

# the f32 kernel's per-depth layout (csrc/gnt_chain.cu, VT_LN1 ... RA_F2B)
_LAYER_ORDER = (
    "vt_ln1", "vt_wq", "vt_wkv", "vt_p0", "vt_p0b", "vt_p1", "vt_p1b",
    "vt_a0", "vt_a0b", "vt_a1", "vt_a1b", "vt_wo", "vt_wob", "vt_ln2",
    "vt_f1", "vt_f1b", "vt_f2", "vt_f2b",
    "ra_ln1", "ra_wqkv_heads", "ra_wo", "ra_wob", "ra_ln2", "ra_f1",
    "ra_f1b", "ra_f2", "ra_f2b")
# the bf16 kernel's per-depth layouts (csrc/gnt_chain.cu, tc::M_* and
# tc::V_*): the matrices as packed B fragments, the vectors in f32
_MATRIX_ORDER = (
    "vt_wq", "vt_wkv", "vt_p0", "vt_p1", "vt_a0", "vt_a1", "vt_wo", "vt_f1",
    "vt_f2", "ra_wq", "ra_wkv", "ra_wo", "ra_f1", "ra_f2")
_VECTOR_ORDER = (
    "vt_ln1", "vt_p0b", "vt_a0b", "vt_wob", "vt_ln2", "vt_f1b", "vt_f2b",
    "ra_ln1", "ra_wob", "ra_ln2", "ra_f1b", "ra_f2b")


def pack_b(w):
    """``w [..., K, N]`` (in, out; N a multiple of 8) as the B fragments of
    ``mma.sync.m16n8k16``, K zero-padded to a multiple of 16: ``[..., K/16,
    N/8, 32, 4]`` where lane ``4 g + t`` of fragment ``(kt, nt)`` holds
    ``w[16 kt + 2 t + (e & 1) + 8 (e >> 1), 8 nt + g]`` for e = 0..3, so a
    lane reads its two registers with one 8-byte load. Flattened per
    leading index: ``[..., K16 * N]``."""
    *lead, k, n = w.shape
    if n % 8:
        raise ValueError(f"N={n} is not a multiple of 8")
    k16 = -(-k // 16) * 16
    full = w.new_zeros((*lead, k16, n))
    full[..., :k, :] = w
    # k = 16 kt + 8 hi + 2 t + lo, n = 8 nt + g -> [kt, nt, g, t, hi, lo]
    nl = len(lead)
    frags = full.reshape(*lead, k16 // 16, 2, 4, 2, n // 8, 8).permute(
        *range(nl), nl, nl + 4, nl + 5, nl + 2, nl + 1, nl + 3)
    return frags.reshape(*lead, k16 * n)


def unpack_b(packed, k, n):
    """Reads ``pack_b``'s blob back through the kernel's fragment indexing
    (lane -> (k, n)): ``[K16 * N] -> [K, N]``. For tests of the layout."""
    k16 = -(-k // 16) * 16
    flat = packed.reshape(-1)
    out = flat.new_zeros((k16, n))
    nt_n = n // 8
    for kt in range(k16 // 16):
        for nt in range(nt_n):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                base = ((kt * nt_n + nt) * 32 + lane) * 4
                for e in range(4):
                    out[16 * kt + 2 * t + (e & 1) + 8 * (e >> 1),
                        8 * nt + g] = flat[base + e]
    return out[:k]


def _weight_version(net):
    """Changes whenever a parameter of ``net`` is replaced or written in
    place (``load_state_dict``, an optimizer step, ``.to()``)."""
    return tuple((p.data_ptr(), p._version) for p in net.parameters())


# net -> {(dtype, device): (weight version, blobs)}
_STACKS = weakref.WeakKeyDictionary()


def chain_matrices(net, dtype):
    """Every weight of the chain by name, rounded to ``dtype`` as the JAX
    package casts its params and held in f32: per-depth stacks ``[depth,
    ...]`` (matrices in, out), the q_fc stacks ``[ceil(depth / 2), ...]``
    and the entry MLP. ``Wk @ Wv`` is formed from the rounded factors in
    f32 and rounded once."""
    dev = net.rgb_fc.weight.device

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
        "ra_wq": stack(lambda a: t(a.q_fc), rts),
        "ra_wkv": stack(lambda a: torch.cat([t(a.k_fc), t(a.v_fc)], dim=-1),
                        rts),
        "ra_wo": stack(lambda a: t(a.out_fc), rts),
        "ra_wob": stack(lambda a: b(a.out_fc), rts),
        "ra_ln2": stack(lambda m: ln(m.ff_norm), rblk),
        "ra_f1": stack(lambda m: t(m.ff.fc1), rblk),
        "ra_f1b": stack(lambda m: b(m.ff.fc1), rblk),
        "ra_f2": stack(lambda m: t(m.ff.fc2), rblk),
        "ra_f2b": stack(lambda m: b(m.ff.fc2), rblk),
        "e0": t(net.rgbfeat_fc[0]), "e0b": b(net.rgbfeat_fc[0]),
        "e1": t(net.rgbfeat_fc[2]), "e1b": b(net.rgbfeat_fc[2]),
        "qf_b0": stack(lambda m: b(m[0]), qfs),
        "qf_w1": stack(lambda m: t(m[2]), qfs),
        "qf_b1": stack(lambda m: b(m[2]), qfs),
    }
    # q_fc input rows [q | pe | ve] -> [q | pe, 0 | ve, 0], 3d rows
    qf0 = stack(lambda m: t(m[0]), qfs)
    q0 = torch.zeros((len(qfs), 3 * d, d), device=dev)
    q0[:, :d] = qf0[:, :d]
    q0[:, d:d + _PE] = qf0[:, d:d + _PE]
    q0[:, 2 * d:2 * d + _PE] = qf0[:, d + _PE:]
    f["qf_w0"] = q0
    return f


def _stack_f32(f, net):
    """(entry, layers, qfc): flat float32 blobs in the f32 kernel's layout."""
    d, depth = net.netwidth, net.trans_depth
    hd = d // _N_HEADS
    # ray attention qkv [depth, d, (q|k|v), head, hd] -> per head
    # [d, q_h | k_h | v_h]
    f = dict(f, ra_wqkv_heads=torch.cat([f["ra_wq"], f["ra_wkv"]], dim=-1)
             .reshape(depth, d, 3, _N_HEADS, hd).permute(0, 3, 1, 2, 4))
    layers = torch.cat([f[k].reshape(depth, -1) for k in _LAYER_ORDER], dim=1)
    ci = f["e0"].shape[0]
    e0 = f["e0"].new_zeros((-(-ci // 4) * 4, d))
    e0[:ci] = f["e0"]
    entry = torch.cat([e0.reshape(-1), f["e0b"], f["e1"].reshape(-1),
                       f["e1b"]])
    n_qf = f["qf_w0"].shape[0]
    qfc = torch.cat([f["qf_w0"].reshape(n_qf, -1), f["qf_b0"],
                     f["qf_w1"].reshape(n_qf, -1), f["qf_b1"]], dim=1)
    return (entry.contiguous(), layers.reshape(-1).contiguous(),
            qfc.reshape(-1).contiguous())


def _stack_bf16(f, net):
    """(entry_m, entry_v, layer_m, layer_v, qfc_m, qfc_v): for the entry MLP,
    the depth blocks and the q_fcs, the matrices as bf16 B fragments
    (``pack_b``) in the order the kernel reads them, and the biases and
    LayerNorm parameters as f32 vectors."""
    depth = net.trans_depth
    bf = torch.bfloat16
    # the pos MLP's output bias as row 8 of its matrix: the kernel sets
    # column 8 of the hidden layer (K = 8, padded to 16) to one. The view
    # attention MLP's output bias (vt_a1b) is not passed: it is the same
    # for every view of a channel and the softmax over the views drops it
    f = dict(f, vt_p1=torch.cat([f["vt_p1"], f["vt_p1b"][:, None]], dim=1))
    return tuple(x.contiguous() for x in (
        torch.cat([pack_b(f["e0"]), pack_b(f["e1"])]).to(bf),
        torch.cat([f["e0b"], f["e1b"]]),
        torch.cat([pack_b(f[k]) for k in _MATRIX_ORDER], dim=1).to(bf)
        .reshape(-1),
        torch.cat([f[k].reshape(depth, -1) for k in _VECTOR_ORDER], dim=1)
        .reshape(-1),
        torch.cat([pack_b(f["qf_w0"]), pack_b(f["qf_w1"])], dim=1).to(bf)
        .reshape(-1),
        torch.cat([f["qf_b0"], f["qf_b1"]], dim=1).reshape(-1)))


def stack_weights(net, dtype):
    """The kernel's weights for ``net`` (a ``GNTAggregator``) in ``dtype``,
    made once per net, dtype, device and weight version and then reused by
    every chunk. float32: (entry, layers, qfc) flat f32 blobs. bfloat16:
    (entry_m, entry_v, layer_m, layer_v, qfc_m, qfc_v), the matrices packed
    in bf16 as the tensor-core instruction's B fragments, the vectors in
    f32 (bf16-valued). See ``chain_matrices`` for the rounding."""
    dev = net.rgb_fc.weight.device
    version = _weight_version(net)
    per_net = _STACKS.setdefault(net, {})
    hit = per_net.get((dtype, dev))
    if hit is not None and hit[0] == version:
        return hit[1]
    f = chain_matrices(net, dtype)
    blobs = (_stack_f32 if dtype == torch.float32 else _stack_bf16)(f, net)
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


def bind(lib):
    """Declare the C entries' signatures on a loaded build of the source."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gnt_chain_f32.argtypes = [vp] * 8 + [ci] * 6 + [vp]
    lib.gnt_chain_f32.restype = ci
    lib.gnt_chain_bf16.argtypes = [vp] * 11 + [ci] * 6 + [vp]
    lib.gnt_chain_bf16.restype = ci
    lib.gnt_chain_max_blocks.argtypes = [ci] * 4
    lib.gnt_chain_max_blocks.restype = ci
    lib.gnt_chain_smem_bytes.argtypes = [ci] * 4
    lib.gnt_chain_smem_bytes.restype = ctypes.c_longlong
    lib.gnt_chain_scratch_elems.argtypes = [ci] * 3
    lib.gnt_chain_scratch_elems.restype = ctypes.c_longlong
    lib.gnt_chain_layout.argtypes = [ctypes.POINTER(ci)] * 6
    lib.gnt_chain_layout.restype = ci
    lib.gnt_chain_bf16_resources.argtypes = [ctypes.POINTER(ci)] * 3
    lib.gnt_chain_bf16_resources.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    return bind(load_library("gnt_chain"))


def build():
    """Build ``csrc/gnt_chain.cu`` (``ops/build.py``) and load it."""
    return _lib()


@functools.lru_cache(maxsize=None)
def _layout():
    """Sizes per depth block and per q_fc: (f32 layer, f32 q_fc), then
    the bf16 route's (layer matrices, layer vectors, q_fc matrices, q_fc
    vectors)."""
    vals = [ctypes.c_int() for _ in range(6)]
    _lib().gnt_chain_layout(*(ctypes.byref(v) for v in vals))
    return tuple(v.value for v in vals)


def bf16_kernel_resources(v, s, ci, device_index=None):
    """What the built bf16 kernel takes on the current card at these shapes:
    registers per thread, threads per block, spilled bytes per thread,
    dynamic shared memory per block and blocks resident on the card."""
    regs, threads, local = (ctypes.c_int() for _ in range(3))
    err = _lib().gnt_chain_bf16_resources(*(ctypes.byref(x) for x in
                                            (regs, threads, local)))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {err}")
    if device_index is None:
        device_index = torch.cuda.current_device()
    return dict(registers=regs.value, threads=threads.value,
                spill_bytes=local.value,
                smem_bytes=_lib().gnt_chain_smem_bytes(v, s, ci, 1),
                blocks=_max_blocks(_lib(), device_index, v, s, ci, 1))


@functools.lru_cache(maxsize=None)
def _max_blocks(lib, device_index, v, s, ci, dtype_code):
    with torch.cuda.device(device_index):
        return lib.gnt_chain_max_blocks(v, s, ci, dtype_code)


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
    return launch_chain(_lib(), net, merged, emb)


def launch_chain(lib, net, merged, emb):
    """Launch the kernel of ``lib``, a loaded build of ``csrc/gnt_chain.cu``
    (``gnt_chain`` passes the package's own; a profiler may pass a build
    with other flags, after ``bind``), on CUDA operands. Counts the launch
    in ``gnt_chain.launches``."""
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
    blocks = min(r, _max_blocks(lib, dev.index if dev.index is not None
                                else torch.cuda.current_device(),
                                v, s, ctot - 5, code))
    ci = ctot - 5
    if blocks < 1:
        raise ValueError(
            f"V={v}, S={s} needs {lib.gnt_chain_smem_bytes(v, s, ci, code)}"
            " bytes of shared memory per block, more than the card offers")
    blobs = stack_weights(net, merged.dtype)
    sizes = _layout()
    n_qf = len(range(0, depth, 2))
    if code == 0:
        want = (blobs[0].numel(), depth * sizes[0], n_qf * sizes[1])
    else:
        k16 = -(-ci // 16) * 16
        want = (k16 * d + d * d, 2 * d, depth * sizes[2], depth * sizes[3],
                n_qf * sizes[4], n_qf * sizes[5])
    if tuple(b.numel() for b in blobs) != want:
        raise AssertionError(f"weight blobs of {[b.numel() for b in blobs]} "
                             f"elements, the kernel reads {list(want)}")
    xbuf = torch.empty(
        (blocks, lib.gnt_chain_scratch_elems(v, s, code)),
        dtype=merged.dtype, device=dev)
    q = torch.empty((r, s, d), dtype=merged.dtype, device=dev)
    attn0 = torch.empty((r, s), dtype=merged.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch = lib.gnt_chain_f32 if code == 0 else lib.gnt_chain_bf16
        err = launch(
            merged.data_ptr(), emb.data_ptr(), *(b.data_ptr() for b in blobs),
            xbuf.data_ptr(), q.data_ptr(), attn0.data_ptr(), v, r, s, ci,
            depth, blocks, stream)
    if err != 0:
        raise RuntimeError(f"gnt_chain launch failed: cudaError {err}")
    gnt_chain.launches += 1
    return q, attn0


gnt_chain.launches = 0


def chain_inputs(net, rgb_feat, ray_diff, mask, pts, ray_d, merged=None):
    """(merged, emb) for ``gnt_chain``, in ``rgb_feat``'s dtype. ``merged``:
    a caller's ``[V, R, S, ci + 5]`` buffer that already holds rgb_feat |
    ray_diff | mask (the BSPG render writes it in place), used as it is."""
    dt = rgb_feat.dtype
    pts_emb, views_emb = net.embeddings(pts, ray_d)
    if merged is None:
        merged = torch.cat([rgb_feat, ray_diff.to(dt), mask.to(dt)], dim=-1)
    emb = torch.cat([pts_emb, views_emb], dim=-1).to(dt)
    return merged.contiguous(), emb.contiguous()


def fused_chain_aggregate(net, rgb_feat, ray_diff, mask, pts, ray_d,
                          merged=None):
    """Drop-in for ``net(rgb_feat, ray_diff, mask, pts, ray_d)`` (a
    ``GNTAggregator``) through the chain: [R, 3], or [R, 3 + S] under
    ``ret_alpha``, in ``rgb_feat``'s dtype; ``merged`` as in
    ``chain_inputs``."""
    q, attn0 = gnt_chain(net, *chain_inputs(net, rgb_feat, ray_diff, mask,
                                            pts, ray_d, merged))
    return net.head(q, attn0)
