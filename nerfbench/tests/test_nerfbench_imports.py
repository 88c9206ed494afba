"""Nothing the benchmark runs loads JAX, its libraries or the JAX package,
and the reference loads nothing of the program. Each check runs in a fresh
interpreter; module names are compared by their whole top-level name
(``nerfool_tpu_torch`` begins with ``nerfool_tpu``)."""
import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = ["jax", "jaxlib", "flax", "optax", "nerfool_tpu"]


def top_level_modules(code):
    probe = (f"{code}\nimport sys, json\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("code", [
    "import nerfbench.run",
    "import nerfbench.kinds.attack, nerfbench.kinds.render",
    # what a run imports of the program: the evaluator and its step
    "import nerfbench.run, nerfool_tpu_torch.engine, "
    "nerfool_tpu_torch.attack.attack",
])
def test_runner_loads_no_jax(code):
    assert not top_level_modules(code) & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    mods = top_level_modules(
        "import nerfbench.reference.attack, nerfbench.reference.render, "
        "nerfbench.reference.gnt, nerfbench.reference.ibrnet, "
        "nerfbench.reference.resunet, nerfbench.compare")
    assert not mods & set(FORBIDDEN + ["nerfool_tpu_torch"])


def test_forbidden_check_compares_whole_names():
    from nerfbench.run import forbidden_modules

    sys.modules.setdefault("nerfool_tpu_torch", sys.modules[__name__])
    assert "nerfool_tpu" not in forbidden_modules()
