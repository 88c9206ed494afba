"""The pixelNeRF backbone (``backbones/pixelnerf.py``) and its cell
``pixelnerf_mv_attack`` (kind ``attack_drawn``): what
``test_nerfbench_backbones.py`` asks of a backbone (the seeded weights with
the BatchNorms' buffers, the reference model, the reference attack steps,
the ``mfu`` readers), the cell's run end to end at the tiny size on the CPU
and with its timed path broken, the operation counts pinned at the cell's
shapes and held to PyTorch's own count of the reference modules, the new
readers on span records, and, on the card, the TF32 control.

    python -m pytest nerfbench/tests/test_nerfbench_pixelnerf.py -m cuda
"""
import ast
import os
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from nerfbench import program, run
from nerfbench.backbones import pixelnerf as backbone
from nerfbench.counts import PEAK_FLOPS, least_seconds
from nerfbench.counts import pixelnerf as counts
from nerfbench.reference import pixelnerf as ref
from nerfbench.session import Traced
from nerfbench.tests.tiny import tiny_cell
from nerfool_tpu_torch.utils.profiling import SpanRecord

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "pixelnerf_mv_attack"
SEED = 2 ** 31 + 28
BENCH = run.benchmark()
# the CPU's limits at the tiny size (sound runs read 1e-7 to 2e-6)
LIMITS = {"loss_step1": 1e-3, "grad_norm": 0.05, "change_norm": 0.5,
          "coarse_net_median": 1e-4}


def run_tiny(trace=0, seed=SEED):
    return run.run(tiny_cell(CELL, LIMITS), seed, 0.2, trace, "cpu", BENCH)


def test_weights_and_reference_model_carry_buffers():
    cell = tiny_cell(CELL)
    sd = program.weights(cell.config, cell.traffic, SEED, "cpu")
    feats = sd["feature_net"]
    assert torch.equal(feats["model.bn1.running_var"], torch.ones(64))
    assert torch.equal(feats["model.layer3.0.downsample.1.running_mean"],
                       torch.zeros(256))
    assert feats["model.bn1.num_batches_tracked"].dtype == torch.int64
    assert sd["net_coarse"]["blocks.4.fc_1.weight"].shape == (32, 32)
    assert not torch.equal(sd["net_coarse"]["lin_in.weight"],
                           sd["net_fine"]["lin_in.weight"])
    feature_net, model = program.reference_model(cell.config, cell.traffic,
                                                 sd)
    assert model["backbone"] is backbone
    assert not feature_net.training
    assert feature_net.model.bn1.running_var.device.type == "cpu"


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_end_to_end(trace):
    result, numbers = run_tiny(trace)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(LIMITS)
    assert numbers["coarse_net_median"] < 1e-6  # the same draws both sides
    e2e, layer = run.cell_metrics(BENCH, CELL)
    if trace:
        assert result["metrics"] == {}  # no device time on the CPU
        assert {m["name"] for m in layer} >= {
            "views_stream_ms.attack", "latent_stream_ms.attack",
            "aggregate_roofline.attack", "mfu.attack"}
    else:
        assert set(result["metrics"]) == {m["name"] for m in e2e}


def test_same_seed_same_inputs():
    assert run_tiny()[1] == run_tiny()[1]


def _broken_step(monkeypatch, how):
    import nerfool_tpu_torch.attack.attack as attack

    real = attack.make_attack_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def broken(state, target, src, sel=None, samples=None, **kw):
            if how == "half_batch":
                n = len(sel) // 2
                return step(state, target, src, sel=sel[:n],
                            samples=tuple(x[:n] for x in samples), **kw)
            if how == "other_draws":
                samples = tuple(torch.roll(x, 1, 0) for x in samples)
                return step(state, target, src, sel=sel, samples=samples,
                            **kw)
            _, aux = step(state, target, src, sel=sel, samples=samples, **kw)
            return state, aux  # the state unchanged

        return broken

    monkeypatch.setattr(attack, "make_attack_step", make)


def _altered_aggregate(monkeypatch, rows=4):
    from nerfool_tpu_torch.models.pixelnerf import ResnetFC

    def forward(self, *args, _real=ResnetFC.forward, **kwargs):
        out = _real(self, *args, **kwargs)
        # the first rays' answers replaced by the next rays'
        return torch.cat([out[rows:2 * rows], out[rows:]])

    monkeypatch.setattr(ResnetFC, "forward", forward)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "other_draws", "aggregate_altered"])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    if fault == "aggregate_altered":
        _altered_aggregate(monkeypatch)
    else:
        _broken_step(monkeypatch, fault)
    result, _ = run_tiny()
    assert not result["correct"], result["checks"]


def test_cell_limits_lie_between_their_readings():
    """What ``test_nerfbench_benchmark.py`` checks of every cell's limits,
    against the attack kind's numbers (it picks those by the kind's name,
    ``attack``, and reads this kind's checks against a render's)."""
    from nerfbench.tests.test_nerfbench_benchmark import ATTACK_NUMBERS

    cell = run.load_cell(CELL)
    assert cell.traffic["kind"] == "attack_drawn"
    assert set(cell.limits["checks"]) <= ATTACK_NUMBERS
    for check, lim in cell.limits["checks"].items():
        assert lim["lower"] < lim["limit"] < lim["upper"], check
        assert lim["upper"] >= 3 * lim["lower"], check
        assert lim["why"]


def test_encoder_layers_by_hand():
    # 756x1008: stem 378x504, pool 189x252, layer2 95x126, layer3 48x63
    layers = counts.encoder_layers(756, 1008)
    assert len(layers) == 29
    assert layers[0] == (3, 64, 7, 378, 504)
    assert layers[1] == (64, 64, 3, 189, 252)
    assert layers[7] == (64, 128, 3, 95, 126)
    assert layers[9] == (64, 128, 1, 95, 126)
    assert layers[-1] == (256, 256, 3, 48, 63)


@pytest.mark.parametrize("h, w", [(48, 64), (40, 56)])
def test_encoder_count_matches_pytorch_count(h, w):
    net = ref.Encoder().eval()
    with FlopCounterMode(display=False) as fc:
        net(torch.rand(2, h, w, 3))
    assert counts.encoder_flops(2, h, w) == fc.get_total_flops()


def test_mlp_count_matches_pytorch_count():
    net = ref.ResnetFC(d_hidden=32)
    with FlopCounterMode(display=False) as fc:
        net(torch.rand(3, 5, 7, 512), torch.rand(3, 5, 7, 42))
    assert counts.mlp_flops(3, 35, d_hidden=32) == fc.get_total_flops()


def test_counts_at_the_cells_shapes():
    """Pinned, as ``test_nerfbench_golden.py`` pins the other cells'."""
    f = run.load_cell(CELL).config["flags"]
    assert backbone.feature_flops(f, 10, 756, 1008) == 925_472_378_880
    assert backbone.points_per_ray(f) == (64, 96)
    assert backbone.aggregator_flops(f, 10, 512, False) == 4_072_836_956_160
    assert backbone.aggregator_flops(f, 10, 512, True) == 8_145_673_912_320
    assert counts.mlp_bytes(10, 512 * 160) == 1_830_412_304
    assert counts.mlp_least_seconds(10, 512 * 160) == pytest.approx(
        4_072_836_956_160 / PEAK_FLOPS)
    tiny = tiny_cell(CELL).config["flags"]
    assert backbone.feature_flops(tiny, 4, 48, 64) == 1_479_671_808
    # by hand: 32 rays x (8 + 16) samples x 2 (56,640 x 4 views + 4,224)
    assert backbone.aggregator_flops(tiny, 4, 32, True) == 2 * 354_484_224


def test_mfu_reader():
    f = run.load_cell(CELL).config["flags"]
    trace = types.SimpleNamespace(busy_s=lambda: 0.5, window_s=1.5,
                                  device=[1])
    traced = Traced(trace, 3, f, 512, (), (756, 1008), 10)
    flops = 2 * 925_472_378_880 + 8_145_673_912_320
    assert run.reader("mfu.attack")(traced) == pytest.approx(
        100.0 * flops / 0.5 / PEAK_FLOPS)


def _traced_with_spans(records):
    f = run.load_cell(CELL).config["flags"]
    trace = types.SimpleNamespace(busy_s=lambda: 1.0, window_s=1.0,
                                  device=[("kernel", 0, 1, None)])
    traced = Traced(trace, 2, f, 512, (), (756, 1008), 10)
    traced.spans = records
    return traced


def test_span_readers():
    rec = lambda name, i, parent, ms: SpanRecord(name, i, parent, 0, 1, ms)
    records = [rec("attack.step", 0, None, 400.0),
               rec("attack.render", 1, 0, 150.0),
               rec("render.aggregate.coarse", 2, 1, 40.0),
               rec("pixelnerf.views", 3, 2, 35.0),
               rec("render.aggregate.fine", 4, 1, 60.0),
               rec("pixelnerf.views", 5, 4, 52.0),
               rec("pixelnerf.latent", 6, 0, 6.0),
               rec("render.aggregate.coarse", 7, None, 1000.0)]  # outside
    traced = _traced_with_spans(records)
    assert run.reader("views_stream_ms.attack")(traced) == pytest.approx(
        (35.0 + 52.0) / 2)
    assert run.reader("latent_stream_ms.attack")(traced) == pytest.approx(3.0)
    least = least_seconds(4_072_836_956_160, 1_830_412_304)
    assert run.reader("aggregate_roofline.attack")(traced) == pytest.approx(
        100.0 * 1e3 * least / ((40.0 + 60.0) / 2))
    empty = _traced_with_spans([])
    for name in ("views_stream_ms.attack", "latent_stream_ms.attack",
                 "aggregate_roofline.attack"):
        assert run.reader(name)(empty) is None


def _imported(node):
    """The dotted names an import statement brings in."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom):
        return [f"{node.module}.{a.name}" for a in node.names]
    return []


def test_no_harness_file_outside_the_backbones_names_it():
    """Neither by the string nor by importing its modules: a reader finds
    the backbone through ``backbones.of(flags)``."""
    nets = {n[:-3] for n in os.listdir(os.path.join(HERE, "backbones"))
            if n.endswith(".py") and n != "__init__.py"}
    found = []
    for root, dirs, files in os.walk(HERE):
        rel = os.path.relpath(root, HERE).split(os.sep)[0]
        if rel in ("backbones", "tests"):
            continue
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as fh:
                    tree = ast.parse(fh.read())
                for node in ast.walk(tree):
                    if isinstance(node, ast.Constant) and \
                            node.value == "pixelnerf":
                        found.append((name, node.value))
                    found += [(name, d) for d in _imported(node)
                              if "pixelnerf" in d.split(".")
                              or d.startswith("nerfbench.backbones.")
                              and d.split(".")[2] in nets]
    assert not found


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control runs on the TF32 tensor cores: needs a "
                    "CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 3, 2 ** 31 + 4, 2 ** 31 + 5])
def test_tf32_control_fails_the_cells_limits(seed, card):
    from nerfbench.kinds.attack_drawn import DrawnAttackSession

    cell = run.load_cell(CELL)
    cell.scene = dict(cell.scene, h=cell.scene["h"] // 2,
                      w=cell.scene["w"] // 2)
    s = DrawnAttackSession(cell, seed, card)
    s.program_readings()
    s.free_program()
    numbers = s.judge(s.reference_readings(tf32=True))
    over = {k: numbers[k] for k, lim in cell.limits["checks"].items()
            if not numbers[k] <= lim["limit"]}
    assert over, numbers
