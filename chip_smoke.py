#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``nerfool_tpu_torch``).

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each printing a line; any failure raises and exits non-zero:
  1. device: a CUDA card is required (no CPU fallback); prints
     ``nvidia-smi --query-gpu=name,power.limit``
  2. build: compiles ``csrc/bspg_select.cu`` (nvcc, sm_90a) from the checkout
  3. plan: the slice's BSPG plan (synthetic scene, 15 views at 378x504)
  4. kernel vs plain: ``bspg_select`` against its plain PyTorch version at the
     slice's shapes (rgb and feature tables, f32 and bf16), with timings
  5. cross-device: one small-scene view rendered on the CPU (plain
     selection) and on the card (kernel) with the same weights
  6. the slice: ``Evaluator.evaluate`` (the code ``python -m
     nerfool_tpu_torch.eval`` runs) renders 2 test views whole-frame with
     IBRNet at full width (random seeded weights) through BSPG, after one
     warm-up render whose outputs are checked finite; the kernel's launch
     count must grow by tables x levels x chunks x views
Then a JSON line of kernel results, and as the last line
``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# the slice: configs/ibrnet/eval_llff.txt at full model width, random
# weights, on the procedural synthetic scene at half the flagship's 756x1008.
# 15 views hold out 4 test views and leave 11 train views, of which the
# nearest-view selection takes 10 (it never takes all of them)
SLICE_ARGV = ["--config", os.path.join(ROOT, "configs/ibrnet/eval_llff.txt"),
              "--eval_dataset", "synthetic", "--eval_scenes", "synthetic",
              "--ckpt_path", "", "--num_source_views", "10",
              "--chunk_size", "4096"]
SLICE_DATA = {"n_views": 15, "h": 378, "w": 504}
SLICE_VIEWS = 2
# small scene for the CPU-vs-card check: the fixture the planner accepts
SMALL_ARGV = ["--eval_dataset", "synthetic", "--ckpt_path", "",
              "--num_source_views", "4", "--N_samples", "64",
              "--N_importance", "64", "--inv_uniform", "--chunk_size", "1024"]
SMALL_DATA = {"n_views": 6, "h": 48, "w": 64}

# f32 tables: kernel and plain differ only in summation order
TOL_F32_ABS = 1e-6
# bf16 tables: both accumulate in f32 and round once to bf16, so they differ
# by at most one bf16 ulp of the output (8 significant bits: 2^-7 relative)
TOL_BF16_REL = 2.0 ** -7
# CPU vs card render: float32 on both (TF32 off); the feature net and
# aggregator round in other orders, which reaches the coarse rgb as ~1e-5
TOL_RGB_ABS = 2e-4
TOL_DEPTH_ABS = 2e-3


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0].strip()


def time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def taps_operands(n_rv, ks, ns, p, c, dtype, seed):
    """Selection operands at the given shapes: slot lists of distinct patch
    ids with -1 pads, each sample's pid drawn from its row's slots."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    slots = torch.argsort(torch.rand(n_rv, 4 * ks, device=dev, generator=g),
                          dim=1)[:, :ks].to(torch.int32)
    slots[:, -2:] = -1
    pick = torch.randint(0, ks - 2, (n_rv, ns), device=dev, generator=g)
    pid = torch.gather(slots, 1, pick)
    ly = torch.randint(0, p, (n_rv, ns), device=dev, generator=g,
                       dtype=torch.int32)
    lx = torch.randint(0, p, (n_rv, ns), device=dev, generator=g,
                       dtype=torch.int32)
    w = [torch.rand(n_rv, ns, device=dev, generator=g) for _ in range(4)]
    table = torch.rand(n_rv, ks, (p + 1) ** 2 * c, device=dev,
                       generator=g).to(dtype)
    return (table, slots, pid.contiguous(), ly, lx, *w, p, c)


def main():
    if not os.path.isdir(os.path.join(ROOT, "nerfool_tpu_torch")):
        sys.exit("chip_smoke.py must run from a checkout of the repository "
                 "(nerfool_tpu_torch/ not found beside it)")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    # 1. device
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: torch.cuda.is_available() is False")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log("device", f"{kind}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")

    from nerfool_tpu_torch.engine import Evaluator
    from nerfool_tpu_torch.eval import parse_args
    from nerfool_tpu_torch.ops import bspg_select

    # 2. build
    t0 = time.perf_counter()
    bspg_select.build()
    log("build", f"bspg_select built in {time.perf_counter() - t0:.2f} s "
        f"into {os.path.relpath(bspg_select.BUILD_DIR, ROOT)}")

    # 3. plan the slice (host, numpy)
    args = parse_args(SLICE_ARGV)
    ev = Evaluator(args, dataset_kwargs=SLICE_DATA, device="cuda", seed=0)
    n_src = int(ev._make_src(ev.test_dataset[0])["cameras"].shape[0])
    if n_src != args.num_source_views:
        raise AssertionError(f"{n_src} source views, not "
                             f"{args.num_source_views}")
    t0 = time.perf_counter()
    cfg = ev.view_render_cfg(n_src)
    plan_s = time.perf_counter() - t0
    if cfg.bspg_specs is None:
        raise RuntimeError("the slice did not plan BSPG")
    spec_f, spec_r = cfg.bspg_specs
    log("plan", f"{plan_s:.2f} s host planning; feat p={spec_f.p} "
        f"groups={[(len(v), k) for v, k in spec_f.groups]}, rgb p={spec_r.p} "
        f"groups={[(len(v), k) for v, k in spec_r.groups]}")

    # 4. kernel vs plain at the slice's shapes: n_rv = views x blocks/chunk
    bh, bw = spec_f.block
    n_rv = n_src * (args.chunk_size // (bh * bw))
    shapes = []
    for table, spec, c in (("feat", spec_f, 32), ("rgb", spec_r, 3)):
        ks = max(spec.k_slots(k) for _, k in spec.groups)
        for level, s in (("coarse", args.N_samples),
                         ("fine", args.N_samples + args.N_importance)):
            shapes.append((table, level, torch.float32, ks, spec.p, c,
                           bh * bw * s))
        shapes.append((table, "fine", torch.bfloat16, ks, spec.p, c,
                       bh * bw * (args.N_samples + args.N_importance)))
    checks = []
    for i, (table, level, dtype, ks, p, c, ns) in enumerate(shapes):
        ops = taps_operands(n_rv, ks, ns, p, c, dtype, seed=i)
        out = bspg_select.select_taps(*ops)
        torch.cuda.synchronize()
        ref = bspg_select.select_taps_plain(*ops)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        scale = torch.maximum(out.float().abs(), ref.float().abs())
        if dtype == torch.float32:
            ok = bool((err <= TOL_F32_ABS).all())
            tol = f"abs {TOL_F32_ABS:g}"
        else:
            ok = bool((err <= TOL_BF16_REL * scale + TOL_F32_ABS).all())
            tol = f"rel {TOL_BF16_REL:g} of |out|"
        rel = float((err / scale.clamp_min(1e-6)).max())
        ms = time_ms(lambda: bspg_select.select_taps(*ops), 20)
        plain_ms = time_ms(lambda: bspg_select.select_taps_plain(*ops), 3)
        dt = "f32" if dtype == torch.float32 else "bf16"
        row = dict(table=table, level=level, dtype=dt, n_rv=n_rv, ks=ks, p=p,
                   c=c, ns=ns, max_abs_err=float(err.max()), max_rel_err=rel,
                   ms=ms, plain_ms=plain_ms)
        checks.append(row)
        log("kernel", f"{table}/{level}/{dt} [n_rv={n_rv} Ks={ks} p={p} c={c} "
            f"ns={ns}]: max abs err {row['max_abs_err']:.3g}, max rel "
            f"{rel:.3g} (tol {tol}); kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms; {card}")
        if not ok:
            raise AssertionError(f"bspg_select disagrees with its plain "
                                 f"version: {row}")
        del ops, out, ref, err, scale

    # 5. cross-device render of a small scene, same weights on both
    small = parse_args(SMALL_ARGV)
    ev_cpu = Evaluator(small, dataset_kwargs=SMALL_DATA, device="cpu", seed=0)
    ev_gpu = Evaluator(parse_args(SMALL_ARGV), dataset_kwargs=SMALL_DATA,
                       device="cuda", seed=0)
    data = ev_cpu.test_dataset[0]
    n_small = len(data["src_cameras"])
    renders = []
    with torch.inference_mode():
        for e in (ev_cpu, ev_gpu):
            ret = e.render_view(data, e._make_src(data))["outputs_coarse"]
            renders.append({k: ret[k].float().cpu().numpy()
                            for k in ("rgb", "depth", "mask")})
    torch.cuda.synchronize()
    if ev_gpu.view_render_cfg(n_small).bspg_specs is None:
        raise RuntimeError("the small scene did not plan BSPG")
    a, b = renders
    same = a["mask"] == b["mask"]
    rgb_err = float(np.abs(a["rgb"] - b["rgb"])[same].max())
    depth_err = float(np.abs(a["depth"] - b["depth"])[same].max())
    log("cross-device", f"coarse rgb max abs {rgb_err:.3g} (tol "
        f"{TOL_RGB_ABS:g}), depth max abs {depth_err:.3g} (tol "
        f"{TOL_DEPTH_ABS:g}), mask agreement {same.mean():.5f}")
    if not (same.mean() >= 0.999 and rgb_err <= TOL_RGB_ABS
            and depth_err <= TOL_DEPTH_ABS
            and np.isfinite(b["rgb"]).all() and np.isfinite(b["depth"]).all()):
        raise AssertionError("CPU and card renders disagree")
    del ev_cpu, ev_gpu

    # 6. the slice
    hp = -(-SLICE_DATA["h"] // bh) * bh  # frame padded to whole blocks
    wp = -(-SLICE_DATA["w"] // bw) * bw
    n_chunks = -(-(hp * wp) // args.chunk_size)
    levels = 2 if args.N_importance > 0 else 1
    expected = (len(spec_f.groups) + len(spec_r.groups)) * levels * n_chunks \
        * SLICE_VIEWS
    # warm-up: one render of the first test view (one-time per-shape set-up
    # of cuDNN and cuBLAS, allocator growth); its outputs must be finite
    data = ev.test_dataset[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        ret = ev.render_view(data, ev._make_src(data))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for level in ("outputs_coarse", "outputs_fine"):
        for k in ("rgb", "depth", "weights"):
            if not bool(torch.isfinite(ret[level][k]).all()):
                raise AssertionError(f"non-finite {level}/{k}")
        if tuple(ret[level]["rgb"].shape) != (SLICE_DATA["h"],
                                               SLICE_DATA["w"], 3):
            raise AssertionError(f"{level} rgb shape "
                                 f"{tuple(ret[level]['rgb'].shape)}")
    del ret
    log("warm-up", f"first render {warm_s:.3f} s, outputs finite; {card}")

    bspg_select.select_taps.launches = 0
    res = ev.evaluate(max_views=SLICE_VIEWS, verbose=True)["synthetic"]
    launches = bspg_select.select_taps.launches
    rows = [v for v in res.values() if isinstance(v, dict)]
    render_s = sum(r["render_seconds"] for r in rows)
    rays = SLICE_VIEWS * SLICE_DATA["h"] * SLICE_DATA["w"]
    log("slice", f"{SLICE_VIEWS} views at {SLICE_DATA['h']}x{SLICE_DATA['w']}, "
        f"{n_src} source views, N_samples {args.N_samples} + N_importance "
        f"{args.N_importance}: bspg_select launches {launches} (expected "
        f"{expected}); planner {plan_s:.2f} s; render {render_s:.3f} s; "
        f"{rays / render_s:.1f} rays/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; coarse PSNR "
        f"{res['coarse_mean_psnr']:.4f} SSIM {res['coarse_mean_ssim']:.4f}; "
        f"fine PSNR {res['fine_mean_psnr']:.4f} SSIM "
        f"{res['fine_mean_ssim']:.4f}; {card}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    metrics = [res[k] for k in ("coarse_mean_psnr", "fine_mean_psnr",
                                "coarse_mean_ssim", "fine_mean_ssim")]
    if not np.isfinite(metrics).all():
        raise AssertionError(f"non-finite metrics {metrics}")
    if any(m.split(".")[0] in ("jax", "jaxlib", "flax") for m in sys.modules):
        raise AssertionError("jax was imported")

    head = next(r for r in checks if r["table"] == "feat"
                and r["level"] == "fine" and r["dtype"] == "f32")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "bspg_select", "route": "cuda",
        "source": "nerfool_tpu_torch/csrc/bspg_select.cu",
        "replaces": "nerfool_tpu/ops/bspg_kernel.py:387",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in checks
                           if r["dtype"] == "f32"),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "shapes": checks}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
