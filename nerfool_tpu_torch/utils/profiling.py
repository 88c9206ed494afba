"""Profiling instrumentation (port of ``nerfool_tpu/utils/profiling.py``,
and the port's own spans): a ``torch.profiler`` trace of a block written as
a Chrome trace, named spans around the attack step's, the evaluator's and
the renderer's phases, and the cards' memory statistics.

Spans record only while a ``torch.profiler`` records (with ``trace`` below,
or any other profiler in the process); otherwise ``span`` returns one shared
null context and costs one C call. A span's host begin and end come from
``time.time_ns()``, the clock of the profiler's own events, so that a span
and the operators, runtime calls and (on a card) device activity inside it
line up. On a card a span also records a pair of timing events on the
current stream: its stream ms run from the end of the work enqueued before
the span to the end of the span's own work. Spans are the port's records,
not ``record_function`` ranges: those are mirrored onto the device timeline
as annotations, which readers of device activity would count as busy time.

Span names (the renderer's fire inside ``attack.render`` too):

  attack.step       make_attack_step's step (allocator and launch counters)
  attack.draw       its random draws
  attack.features   the feature net on the perturbed sources
  attack.render     the ray renders of the losses, the pseudo-GT render too
  attack.loss       the loss terms and their sum
  attack.backward   the gradient (PCGrad's per-term gradients, a split's
                    all-reduce)
  attack.update     Adam or the sign step, the projection, the camera clamps
  eval.render_view  Evaluator.render_view (allocator and launch counters)
  eval.features     its feature net
  render.chunk      one chunk of render_single_image's loop
  render.assemble   the chunks concatenated and reshaped to the frame
  render.gather.coarse, .fine      the taps (per tap, or the BSPG selection)
  render.aggregate.coarse, .fine   the aggregator
  render.fine_sampler              the fine depths and points
  render.composite.coarse, .fine   raw output to per-ray outputs
  pixelnerf.latent  pixelNeRF's encoder levels upsampled and concatenated
  pixelnerf.views   its MLP's per-view blocks (lin_in, lin_z, blocks
                    before the views' mean), inside render.aggregate.*
  pixelnerf.pooled  the mean over the views, the other blocks, lin_out
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import itertools
import json
import os
import time
from typing import Optional

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_open = []  # the spans open now, innermost last
_done = []  # finished records not yet taken
_ids = itertools.count()

# the caching allocator's counts that a counting span records the change of
ALLOCATOR_KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


@dataclasses.dataclass
class SpanRecord:
    """A finished span. ``parent``: the ``id`` of the span it opened in
    (None: outermost); ``stream_ms``: None without a card; ``counters``: the
    change across the span of ``ALLOCATOR_KEYS`` (on a card) and of
    ``launches`` (the hand-written kernels' launches), or None where the
    span counts nothing."""

    name: str
    id: int
    parent: Optional[int]
    begin_ns: int
    end_ns: int
    stream_ms: Optional[float] = None
    counters: Optional[dict] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def host_ms(self):
        return (self.end_ns - self.begin_ns) / 1e6


def kernel_launches():
    """Launches of the port's hand-written kernels so far: the sum of their
    wrappers' counters."""
    from nerfool_tpu_torch.ops import (bspg_select, chain, conv2d,
                                       ray_attention, view_attention)

    return (bspg_select.select_taps.launches + chain.gnt_chain.launches
            + conv2d.conv2d_forward.launches
            + conv2d.conv2d_input_grad.launches
            + ray_attention.ray_attention_fwd.launches
            + ray_attention.ray_attention_bwd.launches
            + view_attention.view_attention.launches)


def _counts():
    out = {"launches": kernel_launches()}
    if torch.cuda.is_initialized():
        stats = torch.cuda.memory_stats()
        out.update((k, stats.get(k, 0)) for k in ALLOCATOR_KEYS)
    return out


class _Span:
    __slots__ = ("rec", "counted")

    def __init__(self, name, counters):
        self.rec = SpanRecord(name, next(_ids), None, 0, 0)
        self.counted = counters

    def __enter__(self):
        rec = self.rec
        rec.parent = _open[-1].rec.id if _open else None
        if self.counted:
            rec.counters = _counts()
        if torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            rec.events = (start,)
        _open.append(self)
        rec.begin_ns = time.time_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.end_ns = time.time_ns()
        _open.pop()
        if rec.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec.events = (rec.events[0], end)
        if self.counted:
            now = _counts()
            rec.counters = {k: now[k] - rec.counters.get(k, 0) for k in now}
        _done.append(rec)
        return False


def span(name, counters=False):
    """A context manager around a phase named ``name``: while a profiler
    records, a new span (``counters``: with the allocator's and the kernel
    launches' changes); otherwise one shared null context."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, counters)


def take_spans():
    """The finished spans in the order they ended, their stream ms read
    (which waits for the card to finish them), and the registry cleared."""
    out = list(_done)
    _done.clear()
    pending = [r for r in out if r.events is not None]
    if pending:
        torch.cuda.synchronize()
    for r in pending:
        r.stream_ms = r.events[0].elapsed_time(r.events[1])
        r.events = None
    return out


def chrome_events(records, base_ns=0, tid=1):
    """``records`` as Chrome trace ``"X"`` events on a track of their own
    (thread ``tid`` of this process), at microseconds from ``base_ns`` on
    the host clock (the profiler's own export counts from its
    ``baseTimeNanoseconds``)."""
    pid = os.getpid()
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": "nerfool_tpu_torch spans"}}]
    for r in records:
        args = {"id": r.id, "parent": r.parent, "stream_ms": r.stream_ms}
        args.update(r.counters or {})
        out.append({"ph": "X", "cat": "span", "name": r.name, "pid": pid,
                    "tid": tid, "ts": (r.begin_ns - base_ns) / 1e3,
                    "dur": (r.end_ns - r.begin_ns) / 1e3, "args": args})
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host activity, and
    the CUDA cards' kernels where there is a card) into
    ``log_dir/trace.json``, a Chrome trace that Perfetto and
    chrome://tracing open, with the spans that ended in the block on a
    track of their own; written also when the block raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    t0 = time.time_ns()
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        records = [r for r in take_spans() if r.begin_ns >= t0]
        with open(path) as f:
            doc = json.load(f)
        doc["traceEvents"] += chrome_events(
            records, doc.get("baseTimeNanoseconds", 0))
        with open(path, "w") as f:
            json.dump(doc, f)


def device_intervals(prof):
    """(name, start_ns, end_ns) of every device activity a finished
    ``torch.profiler.profile`` recorded, on the host clock."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(ev.name(), ev.start_ns(), ev.end_ns())
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == cuda]


def merged(intervals):
    """The union of (start, end) intervals, as sorted disjoint [start, end]
    pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def innermost(records):
    """The host timeline cut where the innermost open span changes:
    (starts, names), ``names[i]`` open from ``starts[i]`` to
    ``starts[i + 1]`` (None: no span open)."""
    starts, names, stack = [], [], []

    def close_until(t):
        while stack and stack[-1].end_ns <= t:
            top = stack.pop()
            starts.append(top.end_ns)
            names.append(stack[-1].name if stack else None)

    for r in sorted(records, key=lambda r: (r.begin_ns, -r.end_ns)):
        close_until(r.begin_ns)
        stack.append(r)
        starts.append(r.begin_ns)
        names.append(r.name)
    close_until(float("inf"))
    return starts, names


def idle_by_span(busy, records):
    """Device-idle ns between the busy intervals ``busy`` (merged), by the
    name of the innermost span open on the host when each gap began
    (None: no span open)."""
    starts, names = innermost(records)
    out = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        i = bisect.bisect_right(starts, a) - 1
        key = names[i] if i >= 0 else None
        out[key] = out.get(key, 0) + (b - a)
    return out


def device_memory_stats():
    """Per-card memory statistics of this process's caching allocator
    (``torch.cuda.memory_stats``) under the JAX package's keys:
    ``bytes_in_use`` and ``peak_bytes_in_use`` (allocated bytes, now and
    at the peak since the last ``torch.cuda.reset_peak_memory_stats``) and
    ``bytes_limit`` (the card's memory), keyed ``cuda:i``. Without a card,
    ``{"cpu": None}``: the CPU exposes none."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    out = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
