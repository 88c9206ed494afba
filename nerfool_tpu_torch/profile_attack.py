"""Where an attack iteration's time goes on the card: device time by kernel.

    python -m nerfool_tpu_torch.profile_attack <eval_adv flags>

Takes the flags of ``python -m nerfool_tpu_torch.eval_adv`` and nothing of
its own. On the first test view it runs 2 warm-up iterations and 10
unprofiled ones (host clock, ending in a device synchronize); for GNT it
takes that timing for both routes of the ray attention in one process, in the
order fused, unfused, unfused, fused (``--gnt_fused_attack`` True and
False), so the two are compared on one card under one load. Then 3
iterations of the route the flags name run under ``torch.profiler`` (CPU and
CUDA activities). Printed: the card's name and power limit, the unprofiled ms
per iteration and peak device memory of every timed run, and the profiled
window's device time by kernel and by PyTorch operator, with the share of the
window's wall time the device was busy.
No BSPG plan is made: the attack gathers per tap.
"""
from __future__ import annotations

import subprocess
import time

import torch

from nerfool_tpu_torch.config import port_parser

WARMUP_ITERS, TIMED_ITERS, PROFILE_ITERS, TOP = 2, 10, 3, 25


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def _timed(ev, data):
    """(ms per iteration, peak GiB) of TIMED_ITERS after WARMUP_ITERS."""
    ev.args.adv_iters = WARMUP_ITERS
    ev.attack_view_specific(data)
    ev.args.adv_iters = TIMED_ITERS
    torch.cuda.reset_peak_memory_stats()
    ev.attack_view_specific(data)
    return (ev.last_attack["seconds"] / TIMED_ITERS * 1e3,
            torch.cuda.max_memory_allocated() / 2 ** 30)


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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        ev.attack_view_specific(data)
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
    busy = sum(r[0] for r in tables["kernel"])
    n = PROFILE_ITERS
    print(f"profiled window, gnt_fused_attack {route}: {n} iterations, wall "
          f"{wall_ms:.1f} ms, device kernel time {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f}% of wall)")
    # kernels: every device kernel once; operators: the same device time
    # attributed to the PyTorch operator that launched it (hand-written
    # kernels launched through ctypes appear under kernels only)
    for title, rows in tables.items():
        print(f"-- device time by {title}")
        print(f"{'ms/iter':>10} {'share':>7} {'calls/iter':>10}  {title}")
        for dev_ms, count, key in rows[:TOP]:
            print(f"{dev_ms / n:10.3f} {100 * dev_ms / busy:6.1f}% "
                  f"{count / n:10.1f}  {key[:90]}")
    return tables


if __name__ == "__main__":
    main()
