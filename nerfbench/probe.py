"""Where an attack cell's iteration time goes, and how far the profiler
moves device times, in one process on the card.

    python3 -m nerfbench.probe --workload <attack cell> --seed <n> \\
        [--iterations 40]

Builds the cell as a run does (its checked steps warm every shape), then
prints one JSON line:

- ``untraced``: iterations as the window drives them (the host at most
  ``window.LEAD`` ahead): each one's device ms (CUDA events between
  iterations) and the host ms its call took; the caching allocator's
  device allocations, frees and retries over them;
- ``from_idle``: iterations each begun on an idle device: the host ms of
  the call and the device ms from its first to its last event, so that
  a host that enqueues more slowly than the device runs shows;
- ``feature_net``: the feature net's forward and its backward to the input
  alone, by CUDA events, untraced and under the profiler, beside the device
  ms that the trace puts under the convolution operators for the same
  calls (what ``conv_device_ms`` reads);
- ``traced``: ``trace_units`` iterations under the profiler as a
  ``--trace 1`` run takes them, by CUDA events, beside the trace's window,
  the union and the sum of its device intervals, and its convolution ms.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from nerfbench import run as bench_run
from nerfbench.readers import under_op
from nerfbench.trace import capture
from nerfbench.window import LEAD


def timed(fn, n, lead=LEAD):
    """``fn(i)`` for i < n, a CUDA event before the first call and after
    each, the host at most ``lead`` calls ahead. :return: (device ms of
    each call, host ms of each call)"""
    marks, host = [torch.cuda.Event(enable_timing=True)], []
    marks[0].record()
    for i in range(n):
        t = time.perf_counter()
        fn(i)
        host.append(1e3 * (time.perf_counter() - t))
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        if len(marks) > lead + 1:
            marks[-1 - lead].synchronize()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])], host


def summary(xs):
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return {"n": len(xs), "median": q[1], "q1": q[0], "q3": q[2],
            "min": min(xs), "max": max(xs)}


def conv_ms(trace):
    return 1e3 * trace.device_s(under_op("convolution"))


def feature_net(session):
    """The feature net's forward and backward to the input, as a step runs
    them, on the perturbed sources."""
    bundle = session.ev.bundle
    x = (session.src["rgbs"] + session.state["delta"]).detach()
    params = [p for p in bundle.feature_net.parameters()]

    def once(_):
        for p in params:
            p.requires_grad_(False)
        xx = x.clone().requires_grad_(True)
        feats = bundle.extract_features(xx)
        torch.autograd.grad(sum(f.sum() for f in feats), xx)

    return once


def probe(cell, seed, iterations):
    from nerfbench.kinds.attack import AttackSession

    s = AttackSession(cell, seed, "cuda")
    s.sync()
    out = {"workload": cell.name, "seed": seed,
           "cudnn": torch.backends.cudnn.version(),
           "cudnn_benchmark": torch.backends.cudnn.benchmark}
    stats = lambda: {k: torch.cuda.memory_stats()[k] for k in (
        "num_device_alloc", "num_device_free", "num_alloc_retries")}
    before = stats()
    dev, host = timed(s.unit_of_work, iterations)
    out["untraced"] = {"device_ms": summary(dev), "host_ms": summary(host),
                       "device_ms_each": dev,
                       "allocator": {k: v - before[k]
                                     for k, v in stats().items()}}
    dev, host = timed(s.unit_of_work, 6, lead=0)
    out["from_idle"] = {"device_ms": summary(dev), "host_ms": summary(host)}
    fnet = feature_net(s)
    dev, _ = timed(fnet, 20)
    (dev_t, _), tr = capture(lambda: timed(fnet, 3), "cuda")
    out["feature_net"] = {"untraced_ms": summary(dev),
                          "traced_ms": summary(dev_t),
                          "trace_conv_ms": conv_ms(tr) / 3}
    units = int(cell.traffic["trace_units"])
    (dev_t, _), tr = capture(lambda: timed(s.unit_of_work, units), "cuda")
    total = sum(e - b for _, b, e, _ in tr.device) / 1e6
    out["traced"] = {"iteration_ms": summary(dev_t),
                     "window_ms": 1e3 * tr.window_s / units,
                     "busy_ms": 1e3 * tr.busy_s() / units,
                     "device_sum_ms": total / units,
                     "conv_ms": conv_ms(tr) / units,
                     "device_events": len(tr.device),
                     "without_operator": sum(op is None
                                             for *_, op in tr.device)}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--iterations", type=int, default=40)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = bench_run.load_cell(a.workload)
    print(json.dumps(probe(cell, a.seed, a.iterations)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
