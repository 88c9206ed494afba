"""The port's clean-eval command line against the JAX evaluator, and the
port's independence from JAX.

``python -m nerfool_tpu_torch.eval`` runs on the procedural ``synthetic``
scene (6 views at 48x64, the fixture the BSPG planner accepts) with the JAX
bundle's weights saved as a reference-layout checkpoint. The JAX
``AdvEvaluator`` renders the same views through the same BSPG plan with its
XLA selection (NERFOOL_FORCE_BSPG=1, bspg_pallas=False; interpreted Pallas
over a whole frame is too slow for the CPU tier). Coarse PSNR is held to
1e-3 dB and SSIM to 1e-4: the rendered rgb agrees to ~1e-5 (see
test_torch_render), which moves either metric far less. The GNT cases hold
the port to the same bounds with GNT's protocol (img2psnr, windowed SSIM).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_engine import _engine_args

from nerfool_tpu.attack.engine import AdvEvaluator
from nerfool_tpu.models.bundle import create_model as j_create_model

from nerfool_tpu_torch import eval as port_eval
from nerfool_tpu_torch.models.bundle import create_model
from nerfool_tpu_torch.models.convert import params_from_flax

SMALL = {"n_views": 6, "h": 48, "w": 64}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_argv(tmp_path, *extra):
    return ["--eval_dataset", "synthetic", "--backbone", "ibrnet",
            "--N_samples", "12", "--N_importance", "0", "--chunk_size", "256",
            "--num_source_views", "4", "--rootdir", str(tmp_path),
            "--device", "cpu", "--dataset_kwargs", json.dumps(SMALL), *extra]


# GNT at small depth: single_net, ret_alpha (as configs/gnt/*.txt set it)
GNT_FLAGS = ("--backbone", "gnt", "--trans_depth", "2", "--ret_alpha")


def _jax_gnt_evaluator(tmp_path, monkeypatch, jb, **overrides):
    """The JAX evaluator on the same BSPG plan with its XLA selection."""
    monkeypatch.setenv("NERFOOL_FORCE_BSPG", "1")
    args = _engine_args(tmp_path, view_specific=True, no_attack=True,
                        backbone="gnt", trans_depth=2, ret_alpha=True,
                        **overrides)
    ev = AdvEvaluator(args, bundle=jb, dataset_kwargs=SMALL)
    n_src = int(ev._make_src(ev.test_dataset[0])["cameras"].shape[0])
    cfg = ev._view_render_cfg(n_src)
    assert cfg.bspg_specs is not None and not cfg.gnt_fused_chain
    ev._bspg_cfg[n_src] = dataclasses.replace(cfg, bspg_pallas=False)
    return ev


@pytest.fixture(scope="module")
def gnt_bundle():
    return j_create_model(backbone="gnt", trans_depth=2, single_net=True,
                          rng_key=jax.random.PRNGKey(4))


def test_eval_cli_matches_jax_evaluator(tmp_path, monkeypatch):
    jb = j_create_model(backbone="ibrnet", rng_key=jax.random.PRNGKey(0))
    ckpt = tmp_path / "model.pth"
    torch.save(params_from_flax(jax.tree.map(np.asarray, jb.params)), ckpt)

    monkeypatch.setenv("NERFOOL_FORCE_BSPG", "1")
    args = _engine_args(tmp_path, view_specific=True, no_attack=True)
    ev = AdvEvaluator(args, bundle=jb, dataset_kwargs=SMALL)
    n_src = int(ev._make_src(ev.test_dataset[0])["cameras"].shape[0])
    cfg = ev._view_render_cfg(n_src)
    assert cfg.bspg_specs is not None
    ev._bspg_cfg[n_src] = dataclasses.replace(cfg, bspg_pallas=False)
    ref = ev.evaluate(verbose=False, save_images=False)["synthetic"]

    out = port_eval.main(_port_argv(tmp_path, "--ckpt_path", str(ckpt)))
    out = out["synthetic"]
    views = [k for k in ref if k.startswith("synthetic_")]
    assert views and sorted(views) == sorted(
        k for k in out if k.startswith("synthetic_"))
    for k in views:
        assert abs(out[k]["coarse_psnr"] - ref[k]["coarse_psnr"]) < 1e-3, k
        assert abs(out[k]["coarse_ssim"] - ref[k]["coarse_ssim"]) < 1e-4, k
        assert np.isnan(out[k]["fine_psnr"])  # N_importance 0: no fine level


def test_gnt_eval_cli_matches_jax_evaluator(tmp_path, monkeypatch,
                                           gnt_bundle):
    ckpt = tmp_path / "gnt.pth"
    torch.save(params_from_flax(jax.tree.map(np.asarray, gnt_bundle.params)),
               ckpt)
    ev = _jax_gnt_evaluator(tmp_path, monkeypatch, gnt_bundle)
    ref = ev.evaluate(verbose=False, save_images=False)["synthetic"]

    out = port_eval.main(_port_argv(tmp_path, *GNT_FLAGS, "--ckpt_path",
                                    str(ckpt)))["synthetic"]
    views = [k for k in ref if k.startswith("synthetic_")]
    assert views and sorted(views) == sorted(
        k for k in out if k.startswith("synthetic_"))
    for k in views:
        assert abs(out[k]["coarse_psnr"] - ref[k]["coarse_psnr"]) < 1e-3, k
        assert abs(out[k]["coarse_ssim"] - ref[k]["coarse_ssim"]) < 1e-4, k


def test_gnt_bf16_route_within_derived_bound(tmp_path, monkeypatch,
                                             gnt_bundle):
    """One bf16 render of the port's route (BSPG with bf16 tables, the plain
    chain: ``--gnt_fused_chain on`` on the CPU) against the JAX bf16 module
    path. Both are held to the JAX f32 render of the same view: the port's
    max error may be at most twice the JAX bf16 render's, for rgb and
    depth."""
    from nerfool_tpu_torch.engine import Evaluator

    renders = {}
    for dtype in ("float32", "bfloat16"):
        ev = _jax_gnt_evaluator(tmp_path, monkeypatch, gnt_bundle,
                                compute_dtype=dtype)
        data = ev.test_dataset[0]
        src = ev._make_src(data)
        ret = ev.render_view(data, jnp.zeros_like(src["rgbs"]), src,
                             src["cameras"])["outputs_coarse"]
        renders[dtype] = {k: np.asarray(ret[k], np.float32)
                          for k in ("rgb", "depth")}
    args = port_eval.parse_args(_port_argv(
        tmp_path, *GNT_FLAGS, "--compute_dtype", "bfloat16",
        "--gnt_fused_chain", "on"))
    tev = Evaluator(args, dataset_kwargs=SMALL, device="cpu",
                    bundle=create_model(args=args, state_dicts=params_from_flax(
                        jax.tree.map(np.asarray, gnt_bundle.params))))
    data = tev.test_dataset[0]
    cfg = tev.view_render_cfg(len(data["src_cameras"]))
    assert cfg.gnt_fused_chain and cfg.compute_dtype == "bfloat16"
    with torch.inference_mode():
        ret = tev.render_view(data, tev._make_src(data))["outputs_coarse"]
    for k in ("rgb", "depth"):
        ref = renders["float32"][k]
        err_j = float(np.abs(renders["bfloat16"][k] - ref).max())
        err_t = float(np.abs(ret[k].float().numpy() - ref).max())
        assert 0 < err_t <= 2.0 * err_j, (k, err_t, err_j)


def test_cli_runs_without_jax(tmp_path):
    """Importing every port module and running the CLI (seeded random
    weights, BSPG plan, one view; IBRNet, then GNT in bf16 through the
    chain) leaves jax and flax out of sys.modules."""
    gnt_argv = _port_argv(tmp_path, '--max_views', '1', *GNT_FLAGS,
                          '--compute_dtype', 'bfloat16',
                          '--gnt_fused_chain', 'on')
    code = (
        "import sys, pkgutil, importlib, nerfool_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'nerfool_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from nerfool_tpu_torch.eval import main\n"
        f"res = main({_port_argv(tmp_path, '--max_views', '1')!r})\n"
        "assert res['synthetic']['coarse_mean_psnr'] > 0\n"
        f"res = main({gnt_argv!r})\n"
        "assert res['synthetic']['coarse_mean_psnr'] > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', "
        "'jaxlib')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout


def test_cli_rejects_missing_card_and_unported_options(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card path")
    with pytest.raises(RuntimeError, match="cuda"):
        port_eval.main(_port_argv(tmp_path, "--device", "cuda"))
    with pytest.raises(ValueError, match="float32"):
        port_eval.main(_port_argv(tmp_path, "--compute_dtype", "bfloat16"))
