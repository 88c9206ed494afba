#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``nerfool_tpu_torch``).

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each printing a line; any failure raises and exits non-zero:
  1. device: a CUDA card is required (no CPU fallback); prints
     ``nvidia-smi --query-gpu=name,power.limit``
  2. build: compiles ``csrc/bspg_select.cu`` (K1) and ``csrc/gnt_chain.cu``
     (K2) from the checkout, one nvcc each, started together (sm_90a)
  3. plan: the IBRNet slice's BSPG plan (synthetic scene, 15 views at
     378x504)
  4. kernel vs plain: ``bspg_select`` against its plain PyTorch version at the
     IBRNet slice's shapes (rgb and feature tables, f32 and bf16), with
     timings
  5. cross-device: one small-scene view rendered on the CPU (plain
     selection) and on the card (kernel) with the same weights
  6. the IBRNet slice: ``Evaluator.evaluate`` (the code ``python -m
     nerfool_tpu_torch.eval`` runs) renders 2 test views whole-frame with
     IBRNet at full width (random seeded weights) through BSPG, after one
     warm-up render whose outputs are checked finite; K1's launch count
     must grow by tables x levels x chunks x views
  7. K2 vs plain: ``gnt_chain`` against ``gnt_chain_plain`` at the GNT
     slice's shapes (10 views, 192 samples, depth 8) on a subset of one
     chunk's rays: f32 to a tight bound, bf16 to a bound derived from the
     plain bf16 chain's own error; CUDA-event timings of both
  8. GNT cross-device: a small-scene bf16 GNT view rendered on the card
     (K1 + K2) against the CPU's plain bf16 render of the same weights, in
     max and mean abs, to a bound derived from a second card render through
     the module path (see gnt_cross_device)
  9. the GNT slice: planned (4x4 blocks), ``bspg_select`` against its plain
     version at the GNT slice's shapes (bf16 and f32 tables), then
     ``Evaluator.evaluate`` renders 2 test views whole-frame with
     ``configs/gnt/gnt_full.txt`` (depth 8, 192 samples, single_net,
     ret_alpha) in bf16 at 378x504 (render_stride 2), 10 source views,
     through K1 and K2, after one warm-up render; K2's launch count must
     equal chunks x levels x views and K1's tables x levels x chunks x views
Then the card line, a JSON line of kernel results, and as the last line
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

# the GNT slice: configs/gnt/gnt_full.txt (depth 8, netwidth 64, 192 samples,
# N_importance 0, single_net, ret_alpha, render_stride 2) in bf16 on the same
# scene, random weights. Chunk 4096 replaces the config's 800, which is not a
# multiple of the BSPG block. The planner rejects 8x8 blocks at stride 2 on
# this scene (the rgb tube radius, 47 px, exceeds the largest patch, 32;
# tests/test_torch_gnt.py::test_slice_rig_rejects_8x8_blocks_at_stride_2
# shows it for the JAX planner and the port's), so the slice plans 4x4
# blocks: 189x252 rays, padded to 192x252, in 12 chunks
GNT_ARGV = ["--config", os.path.join(ROOT, "configs/gnt/gnt_full.txt"),
            "--eval_dataset", "synthetic", "--eval_scenes", "synthetic",
            "--ckpt_path", "", "--num_source_views", "10",
            "--chunk_size", "4096", "--compute_dtype", "bfloat16",
            "--bspg_block", "4"]
GNT_VIEWS = 2
CHAIN_RAYS = 512  # K2 vs plain on a subset of one chunk's rays
# small GNT scene for the CPU-vs-card check (depth 8, fewer samples)
GNT_SMALL_ARGV = ["--config", os.path.join(ROOT, "configs/gnt/gnt_full.txt"),
                  "--eval_dataset", "synthetic", "--eval_scenes",
                  "synthetic", "--ckpt_path", "", "--num_source_views", "4",
                  "--N_samples", "32", "--render_stride", "1",
                  "--chunk_size", "1024"]

# f32 tables: kernel and plain differ only in summation order
TOL_F32_ABS = 1e-6
# bf16 tables: both accumulate in f32 and round once to bf16, so they differ
# by at most one bf16 ulp of the output (8 significant bits: 2^-7 relative)
TOL_BF16_REL = 2.0 ** -7
# CPU vs card render: float32 on both (TF32 off); the feature net and
# aggregator round in other orders, which reaches the coarse rgb as ~1e-5
TOL_RGB_ABS = 2e-4
TOL_DEPTH_ABS = 2e-3
# K2 in f32: summation order only (~1e-6 of the output per product; every
# block's LayerNorms re-normalise): 1e-4 of the output scale
TOL_CHAIN_F32_REL = 1e-4
# K2 in bf16, against the plain chain in f32 on the same bf16 inputs and
# weights: the plain bf16 chain rounds every product and LayerNorm, the
# kernel only x and its outputs, so the kernel's error may be no larger than
# the plain chain's
CHAIN_BF16_FACTOR = 1.0
# GNT bf16 renders: the card's K2 render may sit at most this multiple of
# the plain bf16 path's own card-to-CPU spread from the CPU render (see
# gnt_cross_device); the K2 render rounds less than the plain path, so its
# spread should be no larger, and 2x leaves room for the rounding orders
GNT_RENDER_FACTOR = 2.0


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


def chain_operands(net, v, r, s, seed):
    """K2 operands on the card at the given shapes: rgb in [0, 1], features
    ~ N(0, 1), ray differences with their dot near 1, ~10% of the views
    masked, points and directions ~ N(0, 1)."""
    import torch
    from nerfool_tpu_torch.ops import chain

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    rgb_feat = torch.cat([
        torch.rand(v, r, s, 3, device=dev, generator=g),
        torch.randn(v, r, s, 32, device=dev, generator=g)], dim=-1)
    rd = 0.1 * torch.randn(v, r, s, 4, device=dev, generator=g)
    rd[..., 3] = 1.0 - rd[..., 3].abs()
    mask = (torch.rand(v, r, s, 1, device=dev, generator=g) > 0.1).float()
    return chain.chain_inputs(
        net, rgb_feat, rd, mask, torch.randn(r, s, 3, device=dev, generator=g),
        torch.randn(r, 3, device=dev, generator=g))


def rounded(net, dtype):
    """A copy of ``net`` whose weights hold exactly their ``dtype`` values,
    in float32: the f32 reference on the weights a ``dtype`` run uses."""
    import copy
    import torch

    out = copy.deepcopy(net)
    with torch.no_grad():
        for p in out.parameters():
            p.copy_(p.to(dtype).float())
    return out


def check_chain(net, v, s, card):
    """Phase 7: K2 against its plain version (``GNTAggregator.chain``) at
    the GNT slice's shapes."""
    import torch

    net_b = rounded(net, torch.bfloat16)
    with torch.inference_mode():
        return _check_chain(net, net_b, v, s, card)


def _check_chain(net, net_b, v, s, card):
    import torch
    from nerfool_tpu_torch.ops import chain

    depth = net.trans_depth
    merged, emb = chain_operands(net, v, CHAIN_RAYS, s, seed=7)
    rows = []
    # f32: tight
    got = chain.gnt_chain(net, merged, emb)
    torch.cuda.synchronize()
    ref = chain.gnt_chain_plain(net, merged, emb)
    errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref)]
    tols = [TOL_CHAIN_F32_REL * max(1.0, float(b.abs().max())) for b in ref]
    ms = time_ms(lambda: chain.gnt_chain(net, merged, emb), 3)
    plain_ms = time_ms(lambda: chain.gnt_chain_plain(net, merged, emb), 3)
    rows.append(dict(dtype="f32", rays=CHAIN_RAYS, views=v, samples=s,
                     depth=depth, max_abs_err=max(errs),
                     q_err=errs[0], attn0_err=errs[1], q_tol=tols[0],
                     attn0_tol=tols[1], ms=ms, plain_ms=plain_ms))
    log("K2", f"f32 [V={v} R={CHAIN_RAYS} S={s} depth {depth}]: q max abs "
        f"err {errs[0]:.3g} (tol {tols[0]:.3g}), attn0 {errs[1]:.3g} (tol "
        f"{tols[1]:.3g}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; {card}")
    if not (errs[0] <= tols[0] and errs[1] <= tols[1]
            and all(bool(torch.isfinite(t).all()) for t in got)):
        raise AssertionError(f"gnt_chain f32 disagrees with its plain "
                             f"version: {rows[-1]}")
    del got, ref
    # bf16 (the route): kernel and plain bf16 against plain f32 on the same
    # bf16 inputs and bf16-valued weights
    mb, eb = merged.bfloat16(), emb.bfloat16()
    ref = chain.gnt_chain_plain(net_b, mb.float(), eb.float())
    got = chain.gnt_chain(net, mb, eb)
    plain = chain.gnt_chain_plain(net, mb, eb)
    torch.cuda.synchronize()
    err_k = [float((a.float() - b).abs().max()) for a, b in zip(got, ref)]
    err_p = [float((a.float() - b).abs().max()) for a, b in zip(plain, ref)]
    ms = time_ms(lambda: chain.gnt_chain(net, mb, eb), 3)
    plain_ms = time_ms(lambda: chain.gnt_chain_plain(net, mb, eb), 3)
    rows.append(dict(dtype="bf16", rays=CHAIN_RAYS, views=v, samples=s,
                     depth=depth, q_err=err_k[0], attn0_err=err_k[1],
                     plain_q_err=err_p[0], plain_attn0_err=err_p[1],
                     factor=CHAIN_BF16_FACTOR, ms=ms, plain_ms=plain_ms))
    log("K2", f"bf16 [V={v} R={CHAIN_RAYS} S={s}]: vs f32 plain, kernel q err "
        f"{err_k[0]:.3g} / attn0 {err_k[1]:.3g}, plain bf16 q err "
        f"{err_p[0]:.3g} / attn0 {err_p[1]:.3g} (bound: kernel <= "
        f"{CHAIN_BF16_FACTOR:g} x plain); kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms; {card}")
    if not all(k <= CHAIN_BF16_FACTOR * p for k, p in zip(err_k, err_p)):
        raise AssertionError(f"gnt_chain bf16 outside its bound: {rows[-1]}")
    del got, ref, plain, merged, emb, mb, eb
    # the kernel alone on a whole 4096-ray chunk (the slice's launch shape)
    mb, eb = (t.bfloat16() for t in chain_operands(net, v, 4096, s, seed=8))
    chunk_ms = time_ms(lambda: chain.gnt_chain(net, mb, eb), 2)
    log("K2", f"bf16 whole chunk [V={v} R=4096 S={s}]: kernel {chunk_ms:.1f} "
        f"ms; {card}")
    rows.append(dict(dtype="bf16", rays=4096, views=v, samples=s,
                     depth=depth, ms=chunk_ms))
    return rows


def check_select(shapes, path, seed, card):
    """K1 against its plain version at one path's shapes, each
    (table, level, dtype, n_rv, Ks, p, c, ns); returns the rows."""
    import torch
    from nerfool_tpu_torch.ops import bspg_select

    rows = []
    for i, (table, level, dtype, n_rv, ks, p, c, ns) in enumerate(shapes):
        ops = taps_operands(n_rv, ks, ns, p, c, dtype, seed=seed + i)
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
        row = dict(path=path, table=table, level=level, dtype=dt, n_rv=n_rv,
                   ks=ks, p=p, c=c, ns=ns, max_abs_err=float(err.max()),
                   max_rel_err=rel, ms=ms, plain_ms=plain_ms)
        rows.append(row)
        log("kernel", f"{path} {table}/{level}/{dt} [n_rv={n_rv} Ks={ks} "
            f"p={p} c={c} ns={ns}]: max abs err {row['max_abs_err']:.3g}, "
            f"max rel {rel:.3g} (tol {tol}); kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms; {card}")
        if not ok:
            raise AssertionError(f"bspg_select disagrees with its plain "
                                 f"version: {row}")
        del ops, out, ref, err, scale
    return rows


def gnt_cross_device(card):
    """Phase 8: a small-scene bf16 GNT view rendered on the card through K1
    and K2 (the route) against the CPU's plain bf16 render (plain selection,
    plain chain) of the same weights. The bound comes from a second card
    render through K1 and the module path (bf16 cuBLAS products, rounded at
    every op as the CPU's are): it shares every input with the K2 render
    (bf16 sample points, features, selection), so its distance to the CPU
    render is the plain bf16 path's own cross-device spread. The K2 render's
    distance to the CPU render may be at most GNT_RENDER_FACTOR times that
    spread, in max and in mean abs. An f32 CPU render is printed for context
    only: the NeRF embeddings of bf16 points (the JAX package computes them
    so too) move every bf16 render far from it."""
    import numpy as np
    import torch
    from nerfool_tpu_torch.engine import Evaluator
    from nerfool_tpu_torch.eval import parse_args
    from nerfool_tpu_torch.ops import chain

    renders, launches = {}, {}
    for name, dev, dtype, fused in (("f32", "cpu", "float32", "off"),
                                    ("cpu", "cpu", "bfloat16", "on"),
                                    ("card_module", "cuda", "bfloat16", "off"),
                                    ("card", "cuda", "bfloat16", "on")):
        ev = Evaluator(parse_args(GNT_SMALL_ARGV + [
            "--compute_dtype", dtype, "--gnt_fused_chain", fused]),
            dataset_kwargs=SMALL_DATA, device=dev, seed=0)
        data = ev.test_dataset[0]
        before = chain.gnt_chain.launches
        with torch.inference_mode():
            ret = ev.render_view(data, ev._make_src(data))["outputs_coarse"]
        launches[name] = chain.gnt_chain.launches - before
        renders[name] = {k: ret[k].float().cpu().numpy()
                         for k in ("rgb", "depth", "weights")}
    diff = lambda a, b, k: np.abs(renders[a][k] - renders[b][k])
    errs = {k: dict(card_max=float(diff("card", "cpu", k).max()),
                    card_mean=float(diff("card", "cpu", k).mean()),
                    spread_max=float(diff("card_module", "cpu", k).max()),
                    spread_mean=float(diff("card_module", "cpu", k).mean()),
                    bf16_vs_f32_max=float(diff("cpu", "f32", k).max()))
            for k in ("rgb", "depth", "weights")}
    log("GNT cross-device", "; ".join(
        f"{k}: |card K2 - CPU| max {e['card_max']:.3g} mean "
        f"{e['card_mean']:.3g}, |card module - CPU| max {e['spread_max']:.3g}"
        f" mean {e['spread_mean']:.3g}, |CPU bf16 - f32| max "
        f"{e['bf16_vs_f32_max']:.3g}" for k, e in errs.items())
        + f" (bounds: {GNT_RENDER_FACTOR:g}x the module spread); K2 launches "
        f"{launches['card']} (K2 render), {launches['card_module']} (module "
        f"render); {card}")
    ok = (all(np.isfinite(v).all() for v in renders["card"].values())
          and launches["card"] > 0 and launches["card_module"] == 0
          and all(e["card_max"] <= GNT_RENDER_FACTOR * e["spread_max"]
                  and e["card_mean"] <= GNT_RENDER_FACTOR * e["spread_mean"]
                  for e in errs.values()))
    if not ok:
        raise AssertionError(f"card and CPU GNT renders disagree: {errs}, "
                             f"launches {launches}")
    return errs


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
    from nerfool_tpu_torch.ops import build, bspg_select, chain

    # 2. build both kernels, one nvcc each, in parallel
    t0 = time.perf_counter()
    build.build("bspg_select", "gnt_chain")
    bspg_select.build()
    chain.build()
    log("build", f"bspg_select and gnt_chain built in "
        f"{time.perf_counter() - t0:.2f} s into "
        f"{os.path.relpath(build.BUILD_DIR, ROOT)}")

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
            shapes.append((table, level, torch.float32, n_rv, ks, spec.p, c,
                           bh * bw * s))
        shapes.append((table, "fine", torch.bfloat16, n_rv, ks, spec.p, c,
                       bh * bw * (args.N_samples + args.N_importance)))
    checks = check_select(shapes, "ibrnet", 0, card)

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
    ibr_launches = launches
    del ev

    # 7. K2 against its plain version at the GNT slice's shapes
    gargs = parse_args(GNT_ARGV)
    gev = Evaluator(gargs, dataset_kwargs=SLICE_DATA, device="cuda", seed=0)
    g_src = int(gev._make_src(gev.test_dataset[0])["cameras"].shape[0])
    chain_rows = check_chain(gev.bundle.net_coarse, g_src, gargs.N_samples,
                             card)

    # 8. GNT CPU-vs-card render
    gnt_errs = gnt_cross_device(card)

    # 9. the GNT slice
    t0 = time.perf_counter()
    gcfg = gev.view_render_cfg(g_src)
    g_plan_s = time.perf_counter() - t0
    if gcfg.bspg_specs is None or not gcfg.gnt_fused_chain:
        raise RuntimeError("the GNT slice did not plan BSPG with the chain")
    gbh, gbw = gcfg.bspg_specs[0].block
    hs = len(range(0, SLICE_DATA["h"], gargs.render_stride))
    ws = len(range(0, SLICE_DATA["w"], gargs.render_stride))
    g_chunks = -(-(-(-hs // gbh) * gbh * -(-ws // gbw) * gbw)
                 // gargs.chunk_size)
    g_levels = 2 if gargs.N_importance > 0 else 1
    exp_k2 = g_chunks * g_levels * GNT_VIEWS
    exp_k1 = (sum(len(sp.groups) for sp in gcfg.bspg_specs) * g_levels
              * g_chunks * GNT_VIEWS)
    log("GNT plan", f"{g_plan_s:.2f} s host planning; blocks {gbh}x{gbw}; "
        + "; ".join(f"p={sp.p} groups={[(len(v), k) for v, k in sp.groups]}"
                    for sp in gcfg.bspg_specs))
    # K1 against its plain version at the GNT slice's shapes: bf16 tables
    # (the route) and f32, n_rv = views x blocks/chunk
    g_nrv = g_src * (gargs.chunk_size // (gbh * gbw))
    gshapes = []
    for table, spec, c in (("feat", gcfg.bspg_specs[0], 32),
                           ("rgb", gcfg.bspg_specs[1], 3)):
        ks = max(spec.k_slots(k) for _, k in spec.groups)
        for dtype in (torch.bfloat16, torch.float32):
            gshapes.append((table, "coarse", dtype, g_nrv, ks, spec.p, c,
                            gbh * gbw * gargs.N_samples))
    checks += check_select(gshapes, "gnt", 100, card)
    data = gev.test_dataset[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        ret = gev.render_view(data, gev._make_src(data))["outputs_coarse"]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for k, shape in (("rgb", (hs, ws, 3)), ("depth", (hs, ws)),
                     ("weights", (hs, ws, gargs.N_samples))):
        if tuple(ret[k].shape) != shape or not bool(
                torch.isfinite(ret[k]).all()):
            raise AssertionError(f"GNT warm-up {k}: shape "
                                 f"{tuple(ret[k].shape)}, finite "
                                 f"{bool(torch.isfinite(ret[k]).all())}")
    del ret
    log("GNT warm-up", f"first render {warm_s:.3f} s, outputs finite; {card}")

    torch.cuda.reset_peak_memory_stats()
    bspg_select.select_taps.launches = 0
    chain.gnt_chain.launches = 0
    gres = gev.evaluate(max_views=GNT_VIEWS, verbose=True)["synthetic"]
    k1_gnt = bspg_select.select_taps.launches
    k2_gnt = chain.gnt_chain.launches
    grows = [v for v in gres.values() if isinstance(v, dict)]
    g_render_s = sum(r["render_seconds"] for r in grows)
    g_rays = GNT_VIEWS * hs * ws
    log("GNT slice", f"{GNT_VIEWS} views at {hs}x{ws} rays (378x504, stride "
        f"{gargs.render_stride}), {g_src} source views, depth "
        f"{gargs.trans_depth}, N_samples {gargs.N_samples}, bf16: gnt_chain "
        f"launches {k2_gnt} (expected {exp_k2}), bspg_select launches {k1_gnt}"
        f" (expected {exp_k1}); planner {g_plan_s:.2f} s; render "
        f"{g_render_s:.3f} s; {g_rays / g_render_s:.1f} rays/s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; PSNR "
        f"{gres['coarse_mean_psnr']:.4f} SSIM {gres['coarse_mean_ssim']:.4f};"
        f" {card}")
    if k2_gnt != exp_k2 or k1_gnt != exp_k1:
        raise AssertionError(f"GNT slice launches: gnt_chain {k2_gnt} != "
                             f"{exp_k2} or bspg_select {k1_gnt} != {exp_k1}")
    if not np.isfinite([gres["coarse_mean_psnr"],
                        gres["coarse_mean_ssim"]]).all():
        raise AssertionError(f"non-finite GNT metrics {gres}")
    if any(m.split(".")[0] in ("jax", "jaxlib", "flax") for m in sys.modules):
        raise AssertionError("jax was imported")

    head = next(r for r in checks if r["path"] == "ibrnet" and r["table"]
                == "feat" and r["level"] == "fine" and r["dtype"] == "f32")
    k2_head = next(r for r in chain_rows if r["dtype"] == "bf16")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "bspg_select", "route": "cuda",
        "source": "nerfool_tpu_torch/csrc/bspg_select.cu",
        "replaces": "nerfool_tpu/ops/bspg_kernel.py:387",
        "launches": ibr_launches,
        "launches_by_path": {"ibrnet": ibr_launches, "gnt": k1_gnt},
        "max_abs_err": max(r["max_abs_err"] for r in checks
                           if r["dtype"] == "f32"),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "shapes": checks}, {
        "name": "gnt_chain", "route": "cuda",
        "source": "nerfool_tpu_torch/csrc/gnt_chain.cu",
        "replaces": "nerfool_tpu/ops/chain_kernel.py:220",
        "launches": k2_gnt,
        "max_abs_err": chain_rows[0]["max_abs_err"],
        "ms": k2_head["ms"], "plain_ms": k2_head["plain_ms"],
        "shapes": chain_rows, "render_errors": gnt_errs,
        "slice_rays_per_s": g_rays / g_render_s}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
