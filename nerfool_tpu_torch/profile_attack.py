"""Where an attack iteration's and an attacked render's time goes on the
card: device time by kernel.

    python -m nerfool_tpu_torch.profile_attack <eval_adv flags>

Takes the flags of ``python -m nerfool_tpu_torch.eval_adv`` and nothing of
its own: with ``--view_specific`` the attack on the first test view's own
sources, without it the universal attack on the global source set. It runs
2 warm-up iterations and 10
unprofiled ones (host clock, ending in a device synchronize); for GNT it
takes that timing for both routes of the ray attention in one process, in the
order fused, unfused, unfused, fused (``--gnt_fused_attack`` True and
False), so the two are compared on one card under one load. Then 3
iterations of the route the flags name run under ``torch.profiler`` (CPU and
CUDA activities). Printed: the card's name and power limit, the unprofiled ms
per iteration and peak device memory of every timed run, and the profiled
window's device time by kernel and by PyTorch operator, with the share of the
window's wall time the device was busy (the union of the kernels' intervals),
then the port's spans (``utils/profiling.py``): for each span name its
count, host ms, stream ms, allocator and kernel-launch changes, and the
device-idle ms whose gap began while that span was the innermost one open on
the host. Last, the whole-frame render of the
first test view from the attacked sources, on the route the flags name
(``--gnt_fused_attn``, ``--gnt_fused_vt``, ``--use_bspg``: per tap by
default, ``--use_bspg True`` plans BSPG on the host first):
one warm-up render, one timed, one under the profiler with the same tables.
The attack itself gathers per tap.
"""
from __future__ import annotations

import subprocess
import time

import torch

from nerfool_tpu_torch.config import port_parser
from nerfool_tpu_torch.utils import profiling

WARMUP_ITERS, TIMED_ITERS, PROFILE_ITERS, TOP = 2, 10, 3, 25


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def _attack(ev, data):
    """(delta, src, src_cameras) of ``args.adv_iters`` iterations."""
    if ev.args.view_specific:
        return ev.attack_view_specific(data)
    return ev.attack_universal()


def _timed(ev, data):
    """(ms per iteration, peak GiB) of TIMED_ITERS after WARMUP_ITERS."""
    ev.args.adv_iters = WARMUP_ITERS
    _attack(ev, data)
    ev.args.adv_iters = TIMED_ITERS
    torch.cuda.reset_peak_memory_stats()
    _attack(ev, data)
    return (ev.last_attack["seconds"] / TIMED_ITERS * 1e3,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def print_spans(records, busy, per):
    """The span table of ``records`` against the merged device intervals
    ``busy``, per ``per`` units of work."""
    idle = profiling.idle_by_span(busy, records)
    rows = {}
    for r in records:
        row = rows.setdefault(r.name, {"count": 0, "host": 0.0,
                                       "stream": 0.0, "counters": {}})
        row["count"] += 1
        row["host"] += r.host_ms
        row["stream"] += r.stream_ms or 0.0
        for k, v in (r.counters or {}).items():
            row["counters"][k] = row["counters"].get(k, 0) + v
    print(f"-- spans, per {'iteration' if per > 1 else 'frame'} (idle: "
          f"device-idle ms whose gap began in the span, innermost)")
    print(f"{'count':>8} {'host ms':>10} {'stream ms':>10} {'allocs':>8} "
          f"{'frees':>8} {'retries':>7} {'launches':>8} {'idle ms':>9}  span")
    for name, row in sorted(rows.items(), key=lambda kv: -kv[1]["host"]):
        c = row["counters"]
        cell = lambda k: f"{c[k] / per:.1f}" if k in c else "-"
        print(f"{row['count'] / per:8.1f} {row['host'] / per:10.3f} "
              f"{row['stream'] / per:10.3f} {cell('num_device_alloc'):>8} "
              f"{cell('num_device_free'):>8} "
              f"{cell('num_alloc_retries'):>7} {cell('launches'):>8} "
              f"{idle.get(name, 0) / 1e6 / per:9.3f}  {name}")
    print(f"{'':>66}{idle.get(None, 0) / 1e6 / per:9.3f}  (no span open)")


def profile_device(fn, label, per):
    """Run ``fn`` under the profiler and print its device time by kernel and
    by operator, and the spans it recorded, per ``per`` units of work.
    Returns (fn's result, tables)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    profiling.take_spans()  # spans of earlier profiled work
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    on_device = torch.autograd.DeviceType.CUDA
    tables = {}
    for title, want_kernels in (("kernel", True), ("operator", False)):
        rows = sorted(((_device_us(e) / 1e3, e.count, e.key)
                       for e in prof.key_averages()
                       if (e.device_type == on_device) == want_kernels),
                      reverse=True)
        tables[title] = [r for r in rows if r[0] > 0]
    summed = sum(r[0] for r in tables["kernel"])
    busy = profiling.merged(
        (s, e) for _, s, e in profiling.device_intervals(prof))
    busy_ms = sum(e - s for s, e in busy) / 1e6
    print(f"profiled window, {label}: wall {wall_ms:.1f} ms, device kernel "
          f"time {summed:.1f} ms summed, busy {busy_ms:.1f} ms as their "
          f"union ({100 * busy_ms / wall_ms:.1f}% of wall)")
    # kernels: every device kernel once; operators: the same device time
    # attributed to the PyTorch operator that launched it (hand-written
    # kernels launched through ctypes appear under kernels only)
    for title, rows in tables.items():
        print(f"-- device time by {title}")
        print(f"{'ms':>10} {'share':>7} {'calls':>10}  {title}, per "
              f"{'iteration' if per > 1 else 'frame'}")
        for dev_ms, count, key in rows[:TOP]:
            print(f"{dev_ms / per:10.3f} {100 * dev_ms / summed:6.1f}% "
                  f"{count / per:10.1f}  {key[:90]}")
    print_spans(profiling.take_spans(), busy, per)
    return out, tables


def main(argv=None):
    args = port_parser().parse_args(argv)
    args.distributed = False
    from nerfool_tpu_torch.engine import Evaluator

    ev = Evaluator(args, dataset_kwargs=args.dataset_kwargs,
                   device=args.device, seed=args.seed)
    if ev.device.type != "cuda":
        raise SystemExit("profile_attack measures the card: --device cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    data = ev.test_dataset[0]
    print(f"card: {card}")
    head = (f"{args.backbone} attack, N_rand {args.N_rand}, "
            f"{args.num_source_views} source views")
    route = bool(args.gnt_fused_attack)
    routes = (True, False, False, True) if args.backbone == "gnt" else (route,)
    for fused in routes:
        args.gnt_fused_attack = fused
        ms, peak = _timed(ev, data)
        print(f"{head}, gnt_fused_attack {fused}: {ms:.2f} ms/iteration "
              f"unprofiled ({TIMED_ITERS} iterations after {WARMUP_ITERS}), "
              f"peak device memory {peak:.2f} GiB", flush=True)
    args.gnt_fused_attack = route

    args.adv_iters = PROFILE_ITERS
    (delta, src, cams), tables = profile_device(
        lambda: _attack(ev, data),
        f"{PROFILE_ITERS} iterations, gnt_fused_attack {route}",
        PROFILE_ITERS)

    def render():
        with torch.inference_mode():
            return ev.render_view(data, src, delta, cams)["outputs_coarse"]

    cfg = ev.view_render_cfg(int(cams.shape[0]))  # plans BSPG on the host
    render()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_rays = render()["rgb"][..., 0].numel()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    label = (f"attacked whole-frame render, "
             f"{'BSPG' if cfg.bspg_specs is not None else 'per tap'}, "
             f"gnt_fused_attn {cfg.gnt_fused_attn}, gnt_fused_vt "
             f"{cfg.gnt_fused_vt}")
    print(f"{label}: {n_rays} rays in {seconds:.3f} s unprofiled "
          f"({n_rays / seconds:.1f} rays/s)", flush=True)
    tables["render"] = profile_device(render, label, 1)[1]
    return tables


if __name__ == "__main__":
    main()
