"""The traced window: work run under ``torch.profiler`` (host and CUDA
activity), reduced to what the per-layer readers take.

The profiler's raw events are read directly (one pass, no event tree), so
that a window of a few hundred thousand events reduces in seconds. Each
device activity (kernel, copy, fill) keeps its name, its interval and the
host operator that launched it: the innermost PyTorch operator on the
stack at the launch, or None for launches outside any operator (the
port's hand-written kernels are launched through ``ctypes``).
"""
from __future__ import annotations

import dataclasses
import time

import torch


@dataclasses.dataclass
class Trace:
    window_s: float  # host seconds of the traced work, synchronized at both ends
    device: list  # (name, start_ns, end_ns, launching operator or None)
    host_ops: list  # (name, start_ns, end_ns) of the host operators

    def busy_s(self):
        """Seconds in which any device activity ran: the union of the
        intervals."""
        return self.device_s(lambda name, op: True)

    def device_s(self, match):
        """Seconds in which a device activity for which ``match(name,
        operator)`` is true ran: the union of their intervals, so that
        activities that overlap on the timeline count once."""
        chosen = [d for d in self.device if match(d[0], d[3])]
        return sum(b - a for a, b in merged(chosen)) / 1e9


def merged(device):
    spans = sorted((s, e) for _, s, e, _ in device)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def capture(fn, device):
    """Run ``fn()`` under the profiler. :return: (fn's result, Trace)"""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        window = time.perf_counter() - t0
    return out, reduce(prof, window)


# host events of the profiler itself, which can carry an operator's
# correlation id (PyTorch builds whose events report no activity type)
PROFILER_EVENTS = {"Buffer Flush", "Activity Buffer Request",
                   "Command Buffer Full"}


def is_operator(ev):
    """Whether a host event is an operator (only operators launch)."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return kind() == "cpu_op"
    return ev.name() not in PROFILER_EVENTS


def reduce(prof, window):
    cuda = torch.autograd.DeviceType.CUDA
    ops, dev, host_ops = {}, [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda:
            dev.append((ev.name(), ev.start_ns(), ev.end_ns(),
                        ev.linked_correlation_id()))
        elif ev.linked_correlation_id() == 0:
            if is_operator(ev):
                ops[ev.correlation_id()] = ev.name()
            host_ops.append((ev.name(), ev.start_ns(), ev.end_ns()))
    device = [(n, s, e, ops.get(c)) for n, s, e, c in dev]
    return Trace(window, device, host_ops)


def breakdown(trace, top=10):
    """The device activities that took most time, and the longest idle
    gaps between device activities named by the innermost host operator
    running when the gap began."""
    by_name = {}
    for n, s, e, _ in trace.device:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = merged(trace.device)
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(spans, spans[1:])),
                  reverse=True)[:top]
    named = []
    for length, at in gaps:
        inner = None
        for n, s, e in trace.host_ops:
            if s <= at < e and (inner is None or s >= inner[1]):
                inner = (n, s)
        named.append([(inner[0] if inner else "no host operator")[:120],
                      length / 1e9])
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": named}


def by_operator(trace, top=15):
    """Device seconds by the host operator that launched them (None: no
    operator), most first."""
    out = {}
    for _, s, e, op in trace.device:
        out[op] = out.get(op, 0.0) + (e - s) / 1e9
    return sorted(out.items(), key=lambda kv: -kv[1])[:top]
