"""``BENCHMARK.json`` and the files it names: every cell finds its
configuration, traffic, scene and limits; every limit lies between the
readings it was set from and names a number the comparison produces;
every per-layer metric has its reader; the traffic of the window is the
same set of sizes for every seed."""
import math
import os

import pytest
import torch

from nerfbench import run
from nerfbench.scene import Rig

torch.set_num_threads(2)

BENCH = run.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
ATTACK_NUMBERS = {"loss_step1", "loss_step2", "loss_step3", "loss",
                  "grad_norm", "grad_norm_median", "change_norm",
                  "change_norm_median", "coarse_net_median",
                  "coarse_net_mean"}
RENDER_NUMBERS = {f"{q}_{s}.{lv}" for q in ("rgb", "depth")
                  for s in ("median", "mean", "p999", "max")
                  for lv in ("coarse", "fine", "fine_given_coarse")}


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_and_limits(name):
    cell = run.load_cell(name)
    known = ATTACK_NUMBERS if cell.traffic["kind"] == "attack" else \
        RENDER_NUMBERS
    assert cell.limits["checks"]
    for check, lim in cell.limits["checks"].items():
        assert check in known
        assert lim["lower"] < lim["limit"] < lim["upper"], check
        assert lim["upper"] >= 3 * lim["lower"], check
        assert lim["why"]


def test_every_per_layer_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert callable(run.reader(m["name"]))
        assert set(m["workloads"]) <= set(CELLS)
        e2e, _ = run.cell_metrics(BENCH, m["workloads"][0])
        assert m["moves"] in {x["name"] for x in e2e}


def test_files_under_paths_are_named_from_name_characters():
    allowed = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                  "0123456789_.-/")
    root = os.path.dirname(run.HERE)
    for path in BENCH["paths"]:
        for dirpath, dirs, files in os.walk(os.path.join(root, path)):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), root)
                assert set(rel) <= allowed, rel


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 1, 2 ** 32 + 17])
def test_every_seed_draws_the_same_sizes(seed):
    spec = dict(run.load_cell(CELLS[0]).scene, h=48, w=64)
    rig = Rig(spec, seed, "cpu")
    assert len(rig.views) == math.ceil(spec["n_views"] / spec["llffhold"])
    for view in rig.views:
        assert view["src_rgbs"].shape == (spec["n_src"], 48, 64, 3)
        assert 0.0 <= view["src_rgbs"].min() <= view["src_rgbs"].max() <= 1.0
    assert len(rig.layers) == spec["layers"] + 1
