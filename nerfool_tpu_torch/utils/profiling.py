"""Profiling and throughput instrumentation (port of
``nerfool_tpu/utils/profiling.py``): a ``torch.profiler`` trace of a block
written as a Chrome trace, a throughput meter with warm-up exclusion, and
the cards' memory statistics.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host activity, and
    the CUDA cards' kernels where there is a card) into
    ``log_dir/trace.json``, a Chrome trace that Perfetto and
    chrome://tracing open; written also when the block raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class ThroughputMeter:
    """Tracks items/sec (rays, attack iters) with warmup exclusion: the
    clock starts at the ``warmup``-th step, whose items do not count. On
    the host clock: a caller that times work on a card synchronizes it
    before each ``step``."""

    def __init__(self, warmup=1):
        self.warmup = warmup
        self.count = 0
        self.items = 0
        self.t0 = None

    def step(self, n_items):
        self.count += 1
        if self.count == self.warmup:
            self.t0 = time.perf_counter()
            self.items = 0
        elif self.count > self.warmup:
            self.items += n_items

    @property
    def rate(self):
        if self.t0 is None or self.items == 0:
            return 0.0
        return self.items / (time.perf_counter() - self.t0)


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
