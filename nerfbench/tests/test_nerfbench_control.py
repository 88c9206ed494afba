"""The control of every cell: the reference computed on the TF32 tensor
cores (the nearest precision below the configurations' f32) put in the
program's place must fail at least one of the cell's own limits. On the
card only (TF32 is a tensor-core format), at half the rig's resolution
with every width as published; skipped elsewhere.

    python -m pytest nerfbench/tests/test_nerfbench_control.py -m cuda
"""
import pytest
import torch

from nerfbench import run
from nerfbench.kinds.attack import AttackSession
from nerfbench.kinds.render import RenderSession

torch.set_num_threads(2)

CELLS = ["ibrnet_llff_attack", "gnt_full_attack", "ibrnet_llff_render",
         "gnt_full_render"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control runs on the TF32 tensor cores: needs a "
                    "CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 3, 2 ** 31 + 4, 2 ** 31 + 5])
@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_fails_the_cells_limits(name, seed, card):
    cell = run.load_cell(name)
    cell.scene = dict(cell.scene, h=cell.scene["h"] // 2,
                      w=cell.scene["w"] // 2)
    kind = AttackSession if cell.traffic["kind"] == "attack" else \
        RenderSession
    s = kind(cell, seed, card)
    if s.unit == "frame":
        s.unit_of_work(0)
    s.program_readings()  # the compared pixels
    s.free_program()
    numbers = s.judge(s.reference_readings(tf32=True))
    over = {k: numbers[k] for k, lim in cell.limits["checks"].items()
            if not numbers[k] <= lim["limit"]}
    assert over, numbers
