"""The reference's readings and the flop counts held bit for bit to
``golden.json``, recorded at the tiny cut on the CPU before the backbones
became modules of their own (``nerfbench/backbones/``): each cell's
reference through its kind's own ``reference_readings``
(``tiny.reference_readings``: the attack's loss, first gradient and last
perturbation after the checked steps; the render's rgb and depth of every
level and its coarse weights, the fine level drawn from given coarse
weights included, and every quantity of every level of one chunk of rays
through the backbone's render), and the counts the ``mfu.*`` readers use
at the tiny and the full shapes.

A reading is held by the SHA-256 of its bytes: equal digests are
``rtol=0, atol=0`` and tell -0.0 from 0.0 too. The digests hold for the
torch build, CPU capability and thread count they were recorded on; on
another the readings test skips, the counts test does not. To record them
again (only where the reference's arithmetic is meant to change):

    python -m nerfbench.tests.test_nerfbench_golden
"""
import hashlib
import json
import os

import pytest
import torch

from nerfbench import readers, run
from nerfbench.session import Traced
from nerfbench.tests.tiny import reference_readings, tiny_cell

torch.set_num_threads(2)

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "golden.json")
SEEDS = {"ibrnet_llff_attack": 2 ** 31 + 101, "gnt_full_attack": 2 ** 31 + 102,
         "ibrnet_llff_render": 2 ** 31 + 103, "gnt_full_render": 2 ** 31 + 104}


def platform():
    return {"torch": torch.__version__,
            "cpu": torch.backends.cpu.get_cpu_capability(),
            "threads": torch.get_num_threads()}


def readings(name):
    return reference_readings(tiny_cell(name), SEEDS[name])


def flop_counts(cell, rays=4096):
    """What the ``mfu.*`` readers count at the cell's shapes."""
    scene = cell.scene
    traced = Traced(None, 1, cell.flags, rays, (),
                    (int(scene["h"]), int(scene["w"])), int(scene["n_src"]))
    return {"feature": readers.feature_flops(traced),
            "aggregator": readers.aggregator_flops(traced, rays, False),
            "aggregator_backward": readers.aggregator_flops(traced, rays,
                                                            True)}


def digest(x):
    x = x.detach().contiguous()
    return {"shape": list(x.shape), "dtype": str(x.dtype),
            "sum": float(x.double().sum()),
            "sha256": hashlib.sha256(x.numpy().tobytes()).hexdigest()}


def golden():
    with open(PATH) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", sorted(SEEDS))
def test_reference_readings_are_bit_identical(name):
    want = golden()
    if want["platform"] != platform():
        pytest.skip(f"digests recorded on {want['platform']}, "
                    f"this is {platform()}")
    got = {q: digest(x) for q, x in readings(name).items()}
    assert got == want["readings"][name]


@pytest.mark.parametrize("name", sorted(SEEDS))
def test_flop_counts_are_unchanged(name):
    want = golden()["flops"][name]
    assert flop_counts(tiny_cell(name)) == want["tiny"]
    assert flop_counts(run.load_cell(name)) == want["full"]


if __name__ == "__main__":
    with open(PATH, "w") as fh:
        json.dump({"platform": platform(),
                   "readings": {n: {q: digest(x)
                                    for q, x in readings(n).items()}
                                for n in sorted(SEEDS)},
                   "flops": {n: {"tiny": flop_counts(tiny_cell(n)),
                                 "full": flop_counts(run.load_cell(n))}
                             for n in sorted(SEEDS)}}, fh, indent=1)
        fh.write("\n")
