"""The port's ``utils/profiling.py`` against the JAX package's: the
memory statistics' keys on a stand-in card for each package, and the trace
file (the spans: ``test_torch_spans.py``).
"""
import json
import types

import jax
import pytest
import torch

from nerfool_tpu.utils import profiling as j_prof

from nerfool_tpu_torch.utils import profiling

torch.set_num_threads(2)


def test_device_memory_stats_keys_match_jax(monkeypatch):
    """One stand-in card for each package: the same numbers under the
    same keys; without a card the port reports the CPU with no stats."""
    assert profiling.device_memory_stats() == {"cpu": None}
    stats = {"bytes_in_use": 1 << 20, "peak_bytes_in_use": 3 << 20,
             "bytes_limit": 80 << 30}

    class Card:
        def memory_stats(self):
            return dict(stats, num_allocs=4)

        def __str__(self):
            return "cuda:0"

    monkeypatch.setattr(jax, "devices", lambda: [Card()])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": stats["bytes_in_use"],
        "allocated_bytes.all.peak": stats["peak_bytes_in_use"],
        "reserved_bytes.all.current": 5 << 20})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(
                            total_memory=stats["bytes_limit"]))
    assert profiling.device_memory_stats() == j_prof.device_memory_stats()
    assert profiling.device_memory_stats() == {"cuda:0": stats}


def test_trace_writes_a_chrome_trace(tmp_path):
    """The block's operations land in ``log_dir/trace.json``, which is
    written also when the block raises."""
    x = torch.arange(64.0).reshape(8, 8)
    with profiling.trace(str(tmp_path / "ok")):
        (x @ x).sum()
    with open(tmp_path / "ok" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    with pytest.raises(ValueError, match="inside"):
        with profiling.trace(str(tmp_path / "raised")):
            raise ValueError("inside")
    assert (tmp_path / "raised" / "trace.json").exists()
