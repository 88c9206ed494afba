"""The trace reduction and the per-layer readers on hand-made traces: the
union of device intervals, the idle share, device time under operators
and kernels, the operator test for PyTorch builds whose events carry no
activity type, and readers that stay silent where nothing was traced."""
import pytest
import torch

from nerfbench import run
from nerfbench.session import Traced
from nerfbench.trace import Trace, breakdown, by_operator, is_operator

torch.set_num_threads(2)

MS = 1_000_000  # ns


def traced(device, flags, units=1, window_s=0.01, rays=800, chunks=()):
    tr = Trace(window_s, device, [("aten::div", 0, 10 * MS)])
    return Traced(tr, units, flags, rays, chunks, (756, 1008), 10)


GNT = {"backbone": "gnt", "N_samples": 192, "trans_depth": 8,
       "netwidth": 64, "single_net": "True", "coarse_feat_dim": 32}


def test_union_idle_and_breakdown():
    dev = [("k1", 0, 2 * MS, "aten::cudnn_convolution"),
           ("k2", 1 * MS, 3 * MS, "aten::convolution_backward"),
           ("k3", 6 * MS, 7 * MS, None)]
    t = traced(dev, GNT)
    assert t.trace.busy_s() == pytest.approx(0.004)
    assert run.reader("device_idle_pct.attack")(t) == pytest.approx(60.0)
    # k1 and k2 overlap for 1 ms, which counts once
    assert run.reader("conv_device_ms.attack")(t) == pytest.approx(3.0)
    assert run.reader("gather_device_ms.render")(t) is None
    b = breakdown(t.trace)
    assert b["device_ops"][0] == ["k1", 0.002]
    assert b["idle_gaps"] == [["aten::div", 0.003]]
    assert by_operator(t.trace)[0] == ("aten::cudnn_convolution", 0.002)


def test_kernel_rooflines_read_their_kernels_only():
    t = traced([("void ra_fwd_kernel<float>(float const*)", 0, 1 * MS, None),
                ("void ra_bwd_kernel<float, false>(float const*)", 1 * MS,
                 4 * MS, None)], GNT)
    share = run.reader("k3_roofline.attack")(t)
    assert 0 < share < 100
    assert run.reader("k4_roofline.render")(t) is None


def test_readers_silent_without_device_time():
    t = traced([], GNT)
    for m in run.benchmark()["per_layer"]:
        assert run.reader(m["name"])(t) is None, m["name"]


class _Event:
    def __init__(self, name, kind=None):
        self._name = name
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._name


def test_profiler_events_are_not_operators():
    assert is_operator(_Event("aten::mm"))
    assert not is_operator(_Event("Buffer Flush"))
    assert is_operator(_Event("aten::mm", "cpu_op"))
    assert not is_operator(_Event("Buffer Flush", "overhead"))
