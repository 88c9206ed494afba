"""K3's kernels (``csrc/ray_attention.cu``) on the card: their resources,
their errors, the forward's time with and without the weights' packing and
its clocks by stage, the backward's time with and without weight gradients
beside its plain version.

    python -m nerfool_tpu_torch.profile_ray_attention

Builds the source as the port builds it, with ``-DRA_FWD_STAMPS`` and with
``-DRA_BWD_STAMPS``, the three ``nvcc`` processes started together. Prints the
f32 forward kernel's registers, spilled bytes per thread, threads, shared
memory and resident blocks at S = 192, checks its f32 output against
``ray_attention_plain`` at the attack batch's shape (800 rays, 192 samples)
to 1e-5 of scale, and prints the output's error from the plain version in
float64 beside plain f32's. Then, at that shape and at a render chunk's
(4096 rays), it times with CUDA events the forward with the weights packed
once (as ``ray_attention_fwd`` keeps them) and packed at every launch, in
turns (kept, packed, packed, kept), and the pack alone, and prints the
card's name and power limit beside the times. Then the backward at the
attack batch's shape: its resources without and with weight gradients,
dx, dWqkv and dWo against ``ray_attention_bwd_plain`` (1e-5 of scale) and
against the plain version in float64, and its ms
without and with weight gradients and the plain version's, in turns
(kernel, kernel with dW, plain, plain, kernel with dW, kernel). Last, the
stamped builds: one forward launch at each shape and one backward launch at
the attack batch's, and block 0's warps' clocks summed by stage.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import subprocess

import torch

from nerfool_tpu_torch.ops import build, ray_attention as ra

STAMP_FLAGS = ("-DRA_FWD_STAMPS",)
STAGES = ("k | v products", "first barrier", "q products", "flash steps",
          "attn0 pass", "out product and stores", "second barrier")
BWD_STAMP_FLAGS = ("-DRA_BWD_STAMPS",)
BWD_STAGES = ("projections", "barrier", "flash step", "barrier", "dq",
              "dk and dv", "dx product and stores", "barrier")
SHAPES = ((800, 192), (4096, 192))  # attack batch, attacked-render chunk
REPS = 50
TOL_REL = 1e-5


def operands(r, s, seed, d=64):
    """x ~ N(0, 1) as after a LayerNorm, weights as a Linear's init and
    passed as the module passes them (``[out, in]`` transposed)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = lambda *shape: (torch.rand(*shape, device="cuda", generator=g) * 2
                        - 1) / d ** 0.5
    return (torch.randn(r, s, d, device="cuda", generator=g),
            u(3 * d, d).t(), u(d, d).t(), u(d))


def time_ms(fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_ray_attention measures the card: no CUDA "
                         "device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda f: build.build("ray_attention", flags=f),
                      [(), STAMP_FLAGS, BWD_STAMP_FLAGS]))
    lib = ra.build()
    r, s = SHAPES[0]
    ops = operands(r, s, seed=0)
    res = ra.kernel_resources(s)
    ref_out, ref_a0 = ra.ray_attention_plain(*ops)
    truth = ra.ray_attention_plain(*(t.double() for t in ops))[0]
    scale64 = max(1.0, float(truth.abs().max()))
    plain64 = float((ref_out.double() - truth).abs().max()) / scale64
    out, a0 = ra.launch_fwd(lib, *ops)
    torch.cuda.synchronize()
    errs = [float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
            for a, b in ((out, ref_out), (a0, ref_a0))]
    err64 = float((out.double() - truth).abs().max()) / scale64
    print(f"forward kernel: {res['registers']} registers, "
          f"{res['spill_bytes']} bytes spilled per thread, {res['threads']} "
          f"threads, {res['smem_bytes']} B shared memory, {res['blocks']} "
          f"blocks resident; f32 [R={r} S={s}] error out {errs[0]:.3g}, "
          f"attn0 {errs[1]:.3g} of scale (tol {TOL_REL:g}); out against "
          f"float64 {err64:.3g} of scale (plain f32 {plain64:.3g}); {card}",
          flush=True)
    if not max(errs) <= TOL_REL:
        raise AssertionError(f"the forward disagrees with the plain version: "
                             f"{errs}")
    for r, s in SHAPES:
        ops = operands(r, s, seed=r)
        wpack = ra.pack_weights(lib, ops[1], ops[2], torch.float32)
        kept = lambda: ra.launch_fwd(lib, *ops, wpack=wpack)
        packed = lambda: ra.launch_fwd(lib, *ops)
        turns = [(name, time_ms(fn)) for name, fn in (
            ("kept", kept), ("packed", packed), ("packed", packed),
            ("kept", kept))]
        pack = time_ms(lambda: ra.pack_weights(lib, ops[1], ops[2],
                                               torch.float32))
        print(f"f32 [R={r} S={s}] ms per launch in turns, weights packed "
              "once (kept) or at every launch (packed): " + ", ".join(
                  f"{n} {t:.4f}" for n, t in turns)
              + f"; the pack alone {pack:.4f} ms; {card}", flush=True)
    backward(card)
    stage_cycles(ra.bind(build.load_library("ray_attention", STAMP_FLAGS)),
                 card)
    bwd_stage_cycles(
        ra.bind(build.load_library("ray_attention", BWD_STAMP_FLAGS)), card)


def backward(card):
    """The backward kernel at the attack batch's shape: resources, error,
    and its ms with and without weight gradients against the plain
    version's, in turns."""
    r, s = SHAPES[0]
    x, wqkv, wo, _ = operands(r, s, seed=1)
    g = torch.Generator(device="cuda").manual_seed(2)
    gout = torch.randn(r, s, x.shape[-1], device="cuda", generator=g)
    gattn0 = torch.randn(r, s, device="cuda", generator=g)
    args = (x, wqkv, wo, gout, gattn0)
    dx = ra.ray_attention_bwd(*args, want_dw=False)[0]
    got = (dx, *ra.ray_attention_bwd(*args)[1:])
    ref = ra.ray_attention_bwd_plain(*args)
    truth = ra.ray_attention_bwd_plain(*(t.double() for t in args))
    torch.cuda.synchronize()
    errs = {}
    for name, k, p, t in zip(("dx", "dwqkv", "dwo"), got, ref, truth):
        scale = max(1.0, float(p.abs().max()))
        scale64 = max(1.0, float(t.abs().max()))
        errs[name] = (float((k - p).abs().max()) / scale,
                      float((k.double() - t).abs().max()) / scale64,
                      float((p.double() - t).abs().max()) / scale64)
    for label, dw in (("without weight gradients", False),
                      ("with them", True)):
        res = ra.kernel_resources(s, backward=True, want_dw=dw)
        print(f"backward kernel {label}: {res['registers']} registers, "
              f"{res['spill_bytes']} bytes spilled per thread, "
              f"{res['threads']} threads, {res['smem_bytes']} B shared "
              f"memory, {res['blocks']} blocks resident; {card}", flush=True)
    print(f"backward f32 [R={r} S={s}] error of scale against plain, against"
          f" float64 (plain f32 against float64): " + ", ".join(
              f"{n} {e[0]:.3g}, {e[1]:.3g} ({e[2]:.3g})"
              for n, e in errs.items()) + f" (tol {TOL_REL:g}); {card}",
          flush=True)
    if not max(e[0] for e in errs.values()) <= TOL_REL:
        raise AssertionError(f"the backward disagrees with the plain "
                             f"version: {errs}")
    fns = dict(kernel=lambda: ra.ray_attention_bwd(*args, want_dw=False),
               kernel_dw=lambda: ra.ray_attention_bwd(*args),
               plain=lambda: ra.ray_attention_bwd_plain(*args))
    turns = [(n, time_ms(fns[n], 20)) for n in (
        "kernel", "kernel_dw", "plain", "plain", "kernel_dw", "kernel")]
    print(f"backward f32 [R={r} S={s}] ms in turns (kernel without weight "
          "gradients, kernel_dw with them, plain with them): " + ", ".join(
              f"{n} {t:.4f}" for n, t in turns) + f"; {card}", flush=True)


def stage_cycles(lib, card):
    """One launch of the stamped build per shape: block 0's clocks by
    stage, summed over its warps."""
    read = lib.ray_attention_fwd_stage_cycles
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    for r, s in SHAPES:
        ops = operands(r, s, seed=r)
        ra.launch_fwd(lib, *ops)  # warm-up
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * len(STAGES))()
        if read(buf, 1) != 0:
            raise RuntimeError("could not zero the stage clocks")
        ra.launch_fwd(lib, *ops)
        torch.cuda.synchronize()
        if read(buf, 0) != 0:
            raise RuntimeError("could not read the stage clocks")
        total = sum(buf)
        print(f"stamped f32 [R={r} S={s}], block 0, warp clocks by stage "
              f"(of {total}): " + ", ".join(
                  f"{n} {c} ({100 * c / total:.1f}%)"
                  for n, c in zip(STAGES, buf)) + f"; {card}", flush=True)


def bwd_stage_cycles(lib, card):
    """One launch of the backward's stamped build at the attack batch's
    shape, without weight gradients: block 0's clocks by stage, summed over
    its warps."""
    read = lib.ray_attention_bwd_stage_cycles
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    r, s = SHAPES[0]
    x, wqkv, wo, _ = operands(r, s, seed=r)
    gout, gattn0 = torch.randn_like(x), torch.randn_like(x[..., 0])
    args = (lib, x, wqkv, wo, gout, gattn0)
    ra.launch_bwd(*args)  # warm-up
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * len(BWD_STAGES))()
    if read(buf, 1) != 0:
        raise RuntimeError("could not zero the stage clocks")
    ra.launch_bwd(*args)
    torch.cuda.synchronize()
    if read(buf, 0) != 0:
        raise RuntimeError("could not read the stage clocks")
    total = sum(buf)
    print(f"stamped backward f32 [R={r} S={s}], block 0, warp clocks by "
          f"stage (of {total}): " + ", ".join(
              f"{n} {c} ({100 * c / total:.1f}%)"
              for n, c in zip(BWD_STAGES, buf)) + f"; {card}", flush=True)


if __name__ == "__main__":
    main()
