"""A backbone is one module under ``nerfbench.backbones``, and the harness
needs no other edit for a new one: a stub put there (a one-convolution
feature net with a BatchNorm, whose running statistics are buffers, a
small MLP aggregator, and a ray render of its own) goes through the
seeded weights, the reference model, the reference attack steps, the
render kind's reference and the ``mfu.*`` readers. And no file of the
harness outside ``backbones/`` and ``tests/`` names a backbone."""
import ast
import json
import os
import sys
import types

import pytest
import torch
from torch import nn

from nerfbench import program, run
from nerfbench.counts import PEAK_FLOPS
from nerfbench.reference.render import composite, coarse_depths, gather
from nerfbench.session import Cell, Traced
from nerfbench.tests.tiny import SCENE, reference_readings

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 7
FEAT = 8


class StubFeatures(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, FEAT, 3, stride=2, padding=1)
        self.bn = nn.BatchNorm2d(FEAT)

    def forward(self, x):
        y = torch.relu(self.bn(self.conv(x.permute(0, 3, 1, 2))))
        y = y.permute(0, 2, 3, 1)
        return y, y


class StubNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(3 + FEAT + 4, 16), nn.ReLU(),
                                 nn.Linear(16, 4))

    def forward(self, rgb_feat, diff, mask):
        x = self.mlp(torch.cat([rgb_feat, diff], dim=-1))
        x = torch.sum(x * mask, dim=0) / (torch.sum(mask, dim=0) + 1e-6)
        return torch.cat([torch.sigmoid(x[..., :3]), torch.relu(x[..., 3:])],
                         dim=-1)


def stub_backbone():
    m = types.ModuleType("nerfbench.backbones.stub")
    m.modules = lambda flags: {"feature_net": StubFeatures(),
                               "net_coarse": StubNet()}
    m.model = lambda flags, mods: {"n_samples": int(flags["N_samples"]),
                                   "net": mods["net_coarse"]}

    def render_rays(model, rays_o, rays_d, camera, depth_range, feats,
                    src_rgbs, src_cameras, given=None):
        near, far = depth_range.reshape(-1)[0], depth_range.reshape(-1)[1]
        z = coarse_depths(rays_d.shape[0], near, far, model["n_samples"],
                          False, rays_d)
        pts = z[..., None] * rays_d[:, None] + rays_o[:, None]
        rgb_feat, diff, mask = gather(pts, camera, src_rgbs, src_cameras,
                                      feats[0])
        raw = model["net"](rgb_feat, diff, mask)
        return {"coarse": composite(raw, z, torch.sum(mask[..., 0], 0) > 1),
                "fine": None}

    m.render_rays = render_rays
    m.frame_rgb = lambda coarse: coarse["rgb"]
    m.feature_flops = lambda flags, n_views, h, w: (
        2 * n_views * (h // 2) * (w // 2) * FEAT * 27)
    m.aggregator_flops = lambda flags, n_views, rays, backward: (
        rays * int(flags["N_samples"]) * n_views
        * 2 * ((3 + FEAT + 4) * 16 + 16 * 4) * (3 if backward else 1))
    return m


@pytest.fixture
def stub(monkeypatch):
    module = stub_backbone()
    monkeypatch.setitem(sys.modules, module.__name__, module)
    return module


def stub_cell(traffic):
    with open(os.path.join(HERE, "traffic", f"{traffic}.json")) as fh:
        t = json.load(fh)
    t["check_pixels"] = 256
    config = {"flags": {"backbone": "stub", "N_samples": 16, "N_rand": 32,
                        "chunk_size": 128}}
    return Cell(f"stub_{t['kind']}", config, t, dict(SCENE), {})


def test_weights_and_reference_model_carry_buffers(stub):
    cell = stub_cell("attack_view_specific")
    sd = program.weights(cell.config, cell.traffic, SEED, "cpu")
    again = program.weights(cell.config, cell.traffic, SEED, "cpu")
    feats = sd["feature_net"]
    assert torch.equal(feats["bn.running_mean"], torch.zeros(FEAT))
    assert torch.equal(feats["bn.running_var"], torch.ones(FEAT))
    assert feats["bn.num_batches_tracked"].dtype == torch.int64
    assert int(feats["bn.num_batches_tracked"]) == 0
    assert all(torch.equal(sd[m][k], again[m][k]) for m in sd for k in sd[m])
    feature_net, model = program.reference_model(cell.config, cell.traffic,
                                                 sd)
    assert model["backbone"] is stub
    assert torch.equal(feature_net.bn.running_var, torch.ones(FEAT))


@pytest.mark.parametrize("traffic", ["attack_view_specific", "render_frames"])
def test_stub_runs_through_the_references(stub, traffic):
    out = reference_readings(stub_cell(traffic), SEED)
    assert out and all(torch.isfinite(x.float()).all() for x in out.values())
    if traffic == "attack_view_specific":
        assert out["loss"].shape == (3,)
        assert torch.count_nonzero(out["grad"]) > 0
    else:
        assert out["coarse.rgb"].shape == (3 * 128, 3)
        assert torch.equal(out["coarse.rgb"][:128], out["rays.coarse.rgb"])


@pytest.mark.parametrize("metric", ["mfu.attack", "mfu.render"])
def test_stub_mfu_readers(stub, metric):
    cell = stub_cell("attack_view_specific")
    trace = types.SimpleNamespace(busy_s=lambda: 0.5, window_s=1.0)
    traced = Traced(trace, 2, cell.flags, 32, (32,), (48, 64), 4)
    feature = 2 * 4 * 24 * 32 * FEAT * 27
    per_ray = 16 * 4 * 2 * ((3 + FEAT + 4) * 16 + 16 * 4)
    flops = (2 * feature + 32 * per_ray * 3 if metric == "mfu.attack"
             else feature + 32 * per_ray)
    # two units in a 1 s window: 0.5 s a unit
    assert run.reader(metric)(traced) == pytest.approx(
        100.0 * flops / 0.5 / PEAK_FLOPS)


def _named_backbones(path):
    """String constants of ``path`` that are a backbone's name."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    return [node.lineno for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and node.value.lower() in ("ibrnet", "gnt")]


def test_no_file_outside_the_backbones_names_one():
    found = {}
    for root, dirs, files in os.walk(HERE):
        rel = os.path.relpath(root, HERE).split(os.sep)[0]
        if rel in ("backbones", "tests"):
            continue
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                lines = _named_backbones(path)
                if lines:
                    found[os.path.relpath(path, HERE)] = lines
    assert not found, found
