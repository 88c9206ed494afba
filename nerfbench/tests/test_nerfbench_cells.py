"""Every cell's run end to end at a tiny size on the CPU (the kernels'
plain versions; no card, so the per-layer readers find no device time and
stay silent), and the same runs with the timed path broken underneath,
which must come out not correct.

The limits here are the CPU's at the tiny size, not the cells': on the
card the cells hold their own (``nerfbench/limits``). They sit far above
what sound tiny runs read and far below what each fault reads."""
import json

import pytest
import torch

from nerfbench import run
from nerfbench.tests.tiny import tiny_cell

torch.set_num_threads(2)

SEED = 2 ** 31 + 11  # past 32 signed bits, as the driver's seeds are
ATTACK = {"loss_step1": 1e-3, "grad_norm": 0.05, "change_norm": 0.5,
          "coarse_net_median": 1e-4}
RENDER = {"rgb_mean.coarse": 1e-3, "rgb_p999.coarse": 1e-2}
LIMITS = {"ibrnet_llff_attack": ATTACK, "gnt_full_attack": ATTACK,
          "ibrnet_llff_render": dict(RENDER, **{
              "rgb_median.fine": 1e-3, "rgb_max.fine_given_coarse": 1e-3,
              "depth_max.fine_given_coarse": 1e-3}),
          "gnt_full_render": RENDER}
BENCH = run.benchmark()


def run_tiny(name, trace=0, seed=SEED):
    return run.run(tiny_cell(name, LIMITS[name]), seed, 0.2, trace, "cpu",
                   BENCH)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", sorted(LIMITS))
def test_cell_runs_end_to_end(name, trace):
    result, numbers = run_tiny(name, trace)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) == set(LIMITS[name])
    e2e, layer = run.cell_metrics(BENCH, name)
    if trace:
        assert result["metrics"] == {}  # no device time on the CPU
        assert result["device"]["busy_s"] == 0.0
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert layer
    else:
        assert set(result["metrics"]) == {m["name"] for m in e2e}
        assert all(m["value"] > 0 for m in result["metrics"].values())
    json.dumps(result)


def test_same_seed_same_inputs():
    a = run_tiny("ibrnet_llff_attack")[1]
    b = run_tiny("ibrnet_llff_attack")[1]
    assert a == b


def _broken_step(monkeypatch, how):
    import nerfool_tpu_torch.attack.attack as attack

    real = attack.make_attack_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def broken(state, target, src, sel=None, **kw):
            if how == "half_batch":
                return step(state, target, src, sel=sel[:len(sel) // 2], **kw)
            _, aux = step(state, target, src, sel=sel, **kw)
            return state, aux  # the state unchanged

        return broken

    monkeypatch.setattr(attack, "make_attack_step", make)


def _altered_answer(monkeypatch, level="outputs_coarse", rows=64):
    from nerfool_tpu_torch.engine import Evaluator

    real = Evaluator.render_view

    def render_view(self, *args, **kwargs):
        ret = real(self, *args, **kwargs)
        rgb = ret[level]["rgb"].reshape(-1, 3)
        rgb[:rows] = rgb[rows:2 * rows].clone()  # a block of answers replaced
        return ret

    monkeypatch.setattr(Evaluator, "render_view", render_view)


def _altered_aggregate(monkeypatch, rows=8):
    from nerfool_tpu_torch.models.gnt import GNTAggregator
    from nerfool_tpu_torch.models.ibrnet import IBRNetAggregator

    for cls in (IBRNetAggregator, GNTAggregator):
        def forward(self, *args, _real=cls.forward, **kwargs):
            out = _real(self, *args, **kwargs)
            # the first rays' answers replaced by the next rays'
            return torch.cat([out[rows:2 * rows], out[rows:]])

        monkeypatch.setattr(cls, "forward", forward)


@pytest.mark.parametrize("name, fault", [
    ("ibrnet_llff_attack", "state_unchanged"),
    ("ibrnet_llff_attack", "half_batch"),
    ("ibrnet_llff_attack", "aggregate_altered"),
    ("gnt_full_attack", "state_unchanged"),
    ("gnt_full_attack", "half_batch"),
    ("gnt_full_attack", "aggregate_altered"),
    ("ibrnet_llff_render", "answer_altered"),
    ("gnt_full_render", "answer_altered"),
    ("ibrnet_llff_render", "fine_answer_altered"),
])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    if fault == "answer_altered":
        _altered_answer(monkeypatch)
    elif fault == "aggregate_altered":
        _altered_aggregate(monkeypatch)
    elif fault == "fine_answer_altered":  # a twelfth of the fine level
        _altered_answer(monkeypatch, "outputs_fine", 48 * 64 // 12)
    else:
        _broken_step(monkeypatch, fault)
    result, _ = run_tiny(name)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("shift, want", [(0.0, 0.0), (1e-3, 1e-3),
                                         (None, float("inf"))])
def test_coarse_aggregate_compared_sample_by_sample(shift, want):
    from nerfbench.compare import attack_numbers

    g = torch.Generator().manual_seed(SEED)
    ref = {"loss": torch.ones(3), "grad": torch.rand(4, 6, generator=g),
           "delta0": torch.zeros(4, 6), "delta": torch.rand(4, 6, generator=g),
           "coarse_net": torch.rand(8, 5, 4, generator=g,
                                    dtype=torch.float64)}
    prog = dict(ref, coarse_net=(ref["coarse_net"][:4] if shift is None
                                 else ref["coarse_net"] + shift))
    got = attack_numbers(prog, ref)
    assert got["coarse_net_median"] == pytest.approx(want, rel=1e-9)
    assert got["coarse_net_mean"] == pytest.approx(want, rel=1e-9)
    assert "coarse_net_median" not in attack_numbers(
        dict(prog, coarse_net=None), ref)
