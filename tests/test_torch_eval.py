"""The port's eval command lines (clean and attacked) against the JAX
evaluator, and the port's independence from JAX and from the JAX package.

``python -m nerfool_tpu_torch.eval`` runs on the procedural ``synthetic``
scene (6 views at 48x64, the fixture the BSPG planner accepts) with the JAX
bundle's weights saved as a reference-layout checkpoint. The JAX
``AdvEvaluator`` renders the same views through the same BSPG plan with its
XLA selection (NERFOOL_FORCE_BSPG=1, bspg_pallas=False; interpreted Pallas
over a whole frame is too slow for the CPU tier). Coarse PSNR is held to
1e-3 dB and SSIM to 1e-4: the rendered rgb agrees to ~1e-5 (see
test_torch_render), which moves either metric far less. The GNT cases hold
the port to the same bounds with GNT's protocol (img2psnr, windowed SSIM).

The attacked evaluator (``python -m nerfool_tpu_torch.eval_adv``) is driven
on the CPU for both backbones: finite rows after 2 iterations, the clean
rows exactly under a zero perturbation (``--epsilon 0``), the transfer
attack, and every consistency term, defense and hybrid render mode in a
tiny run (the universal attack's own cases are in
tests/test_torch_universal.py). Attacked
metrics are not compared with JAX's: trajectories diverge chaotically after
a few iterations; tests/test_torch_attack.py compares single steps.
"""
import ast
import dataclasses
import glob
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

from nerfool_tpu.config import config_parser as j_config_parser
from nerfool_tpu.data import dataset_dict as j_dataset_dict

from nerfool_tpu_torch import eval as port_eval
from nerfool_tpu_torch import eval_adv as port_eval_adv
from nerfool_tpu_torch.config import config_parser, port_parser
from nerfool_tpu_torch.data import dataset_dict
from nerfool_tpu_torch.models.bundle import create_model
from nerfool_tpu_torch.models.convert import params_from_flax

from tests.test_torch_attack import _ran, _run_tiny

# the test tier runs several worker processes on a few cores: two math
# threads per process instead of one per core keeps them from thrashing
torch.set_num_threads(2)

SMALL = {"n_views": 6, "h": 48, "w": 64}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_argv(tmp_path, *extra):
    """The port's flags at the small size, on the BSPG route (the per-tap
    gather is the port's default; ``extra`` may say ``--use_bspg False``)."""
    return ["--eval_dataset", "synthetic", "--backbone", "ibrnet",
            "--N_samples", "12", "--N_importance", "0", "--chunk_size", "256",
            "--num_source_views", "4", "--rootdir", str(tmp_path),
            "--device", "cpu", "--dataset_kwargs", json.dumps(SMALL),
            "--use_bspg", "True", *extra]


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


def _adv_argv(tmp_path, *extra):
    """The attacked evaluator at a small size: 2 Adam iterations on 32 rays
    per view, the flagship's attack flags."""
    return _port_argv(tmp_path, "--view_specific", "--use_adam", "--adam_lr",
                      "1e-3", "--adv_lr", "1", "--epsilon", "8",
                      "--adv_iters", "2", "--N_rand", "32", *extra)


def test_cli_runs_without_jax(tmp_path):
    """Importing every port module and running the CLIs (seeded random
    weights, BSPG plan, one view; IBRNet, then GNT in bf16 through the
    chain, then an attacked IBRNet view) leaves jax, flax, optax and the JAX
    package out of sys.modules."""
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
        "from nerfool_tpu_torch.eval_adv import main as adv_main\n"
        f"res = adv_main({_adv_argv(tmp_path, '--max_views', '1')!r})\n"
        "assert res['synthetic']['coarse_mean_psnr'] > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', "
        "'jaxlib', 'optax', 'nerfool_tpu')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"  # as this process: see torch.set_num_threads
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout


def test_cli_rejects_missing_card_and_unported_options(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card path")
    with pytest.raises(RuntimeError, match="cuda"):
        port_eval.main(_port_argv(tmp_path, "--device", "cuda"))
    # every dtype the parser offers runs (IBRNet in bf16 since it is ported:
    # tests/test_torch_bf16.py); one it does not offer is refused
    with pytest.raises(SystemExit):
        port_eval.main(_port_argv(tmp_path, "--compute_dtype", "float16"))
    with pytest.raises(ValueError, match="feature_dtype"):
        create_model(feature_dtype="float16")


def test_no_port_file_imports_jax_or_the_jax_package():
    """Every ``.py`` under ``nerfool_tpu_torch/`` and ``chip_smoke.py``,
    parsed: no import of ``nerfool_tpu``, ``jax``, ``jaxlib``, ``flax`` or
    ``optax``, at any depth of the file; and no imaging package (imageio,
    PIL, matplotlib, cv2, torchvision) at module level, which the card's
    machine lacks (the loaders of image datasets import imageio where they
    read a file)."""
    files = glob.glob(os.path.join(REPO, "nerfool_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 40
    banned = {"nerfool_tpu", "jax", "jaxlib", "flax", "optax"}
    imaging = {"imageio", "PIL", "matplotlib", "cv2", "torchvision"}
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)
        for node in tree.body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] not in imaging, (path, name)


def test_port_config_defaults_equal_the_jax_packages(tmp_path):
    """The port's own flag parser: every flag of the JAX package's parser
    with the same default, from no arguments and from both slice configs;
    ``port_parser`` adds only the port's five flags and pixelNeRF's two
    (no JAX counterpart) and changes one default: whole-frame renders take
    the per-tap gather unless ``--use_bspg True`` (as the JAX evaluator
    renders per tap off the TPU)."""
    for argv in ([], ["--config", os.path.join(REPO, "configs/gnt/gnt_full.txt")],
                 ["--config", os.path.join(REPO, "configs/ibrnet/eval_llff.txt"),
                  "--view_specific", "--adv_iters", "1000", "--epsilon", "8",
                  "--use_adam", "--adam_lr", "1e-3", "--adv_lr", "1"]):
        ref = vars(j_config_parser().parse_args(argv))
        assert vars(config_parser().parse_args(argv)) == ref
        got = vars(port_parser().parse_args(argv))
        assert set(got) - set(ref) == {"device", "seed", "max_views",
                                       "dataset_kwargs", "gnt_fused_vt"} | {
            "pixelnerf_d_hidden", "pixelnerf_n_depth"}
        assert ref["use_bspg"] is True and got["use_bspg"] is False
        assert {k: got[k] for k in ref if k != "use_bspg"} == {
            k: v for k, v in ref.items() if k != "use_bspg"}


def test_port_synthetic_dataset_equals_the_jax_packages(tmp_path):
    """The port's copy of the data package: the same dataset keys, and the
    procedural scene yields the same arrays."""
    assert set(dataset_dict) == set(j_dataset_dict)
    args = port_parser().parse_args(_port_argv(tmp_path))
    a = dataset_dict["synthetic"](args, "test", scenes=[], **SMALL)
    b = j_dataset_dict["synthetic"](args, "test", scenes=[], **SMALL)
    assert len(a) == len(b) > 0
    for i in range(len(a)):
        da, db = a[i], b[i]
        assert set(da) == set(db)
        for k in da:
            if isinstance(da[k], np.ndarray):
                np.testing.assert_array_equal(da[k], db[k], err_msg=k)
            else:
                assert da[k] == db[k], k
    for x, y in zip(a.target_cameras(), b.target_cameras()):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("backbone", ["ibrnet", "gnt"])
def test_attacked_eval_cli_runs(tmp_path, monkeypatch, backbone):
    """``eval_adv`` on the CPU: 2 attack iterations per view, then the
    attacked whole-frame render: finite rows, an attack time per view, the
    results file; GNT through the fused route (the kernel's plain versions
    on the CPU), on the differentiated step and on the render."""
    monkeypatch.chdir(tmp_path)
    extra = (GNT_FLAGS + ("--gnt_fused_attack", "True", "--gnt_fused_attn",
                          "on") if backbone == "gnt" else ())
    res = port_eval_adv.main(_adv_argv(tmp_path, "--max_views", "2",
                                       *extra))["synthetic"]
    rows = [v for v in res.values() if isinstance(v, dict)]
    assert len(rows) == 2
    for row in rows:
        assert np.isfinite([row["coarse_psnr"], row["coarse_ssim"]]).all()
        assert row["attack_seconds"] > 0 and row["render_seconds"] > 0
    assert np.isfinite(res["coarse_mean_psnr"])
    out = tmp_path / "synthetic" / "exp" / "synthetic" / "psnr_synthetic.txt"
    assert "coarse_mean_psnr" in out.read_text()


@pytest.mark.parametrize("backbone", ["ibrnet", "gnt"])
def test_zero_perturbation_reproduces_clean_rows(tmp_path, monkeypatch,
                                                 backbone):
    """``--epsilon 0`` projects delta to zero after every step: the attacked
    evaluator then renders the clean sources, and its rows equal the clean
    evaluator's exactly."""
    monkeypatch.chdir(tmp_path)
    extra = GNT_FLAGS if backbone == "gnt" else ()
    clean = port_eval.main(_port_argv(tmp_path, "--max_views", "2",
                                      *extra))["synthetic"]
    adv = port_eval_adv.main(_adv_argv(tmp_path, "--max_views", "2",
                                       "--epsilon", "0", *extra))["synthetic"]
    for k, row in clean.items():
        if isinstance(row, dict):
            for name in ("coarse_psnr", "coarse_ssim"):
                assert adv[k][name] == row[name], (k, name)
        elif not np.isnan(row):
            assert adv[k] == row, k


def test_transfer_attack_reuses_the_first_views_delta(tmp_path, monkeypatch):
    """``--use_trans_attack``: only the first view is attacked; the later
    views render their own sources with its delta."""
    monkeypatch.chdir(tmp_path)
    res = port_eval_adv.main(_adv_argv(
        tmp_path, "--max_views", "2", "--use_trans_attack"))["synthetic"]
    rows = [v for v in res.values() if isinstance(v, dict)]
    assert "attack_seconds" in rows[0] and "attack_seconds" not in rows[1]
    assert np.isfinite([r["coarse_psnr"] for r in rows]).all()


@pytest.mark.parametrize("flags,ran", [
    (("--view_specific", "--geo_noise", "0.1"), {"rgb", "geo_noise"}),
    (("--view_specific", "--use_pcgrad", "--ds_rgb"), {"rgb"}),
    (("--view_specific", "--perturb_camera", "--camera_consistency_loss",
      "0.5"), {"rgb", "camera_cons"}),
    (("--view_specific", "--depth_consistency_loss", "0.5"),
     {"rgb", "depth_cons"}),
    (("--view_specific", "--camera_consistency_loss", "0.5"),
     {"rgb", "camera_cons"}),
    (("--view_specific", "--ds_rgb"), {"rgb"}),
    (("--view_specific", "--use_purification"), {"rgb", "purification"}),
    (("--view_specific", "--def_random_noise", "0.1"),
     {"rgb", "random_noise"}),
    (("--view_specific", "--use_unseen_views", "--use_purification"),
     {"rgb", "purification"}),
    (("--view_specific", "--use_clean_color"), {"rgb", "use_clean_color"}),
    (("--view_specific", "--no_attack", "--use_clean_density"),
     {"use_clean_density"}),
])
def test_defense_and_consistency_options_run_by_name(tmp_path, monkeypatch,
                                                     flags, ran):
    """Each flag set in a tiny view-specific ``eval_adv`` run (1 iteration,
    1 purification step, 32 rays) gives finite rows and reports the terms,
    defenses and render modes it ran (``--ds_rgb`` without the
    depth-consistency term changes nothing, as in JAX)."""
    monkeypatch.chdir(tmp_path)
    ev, _ = _run_tiny(tmp_path, _port_argv(
        tmp_path, "--adv_iters", "1", "--purif_iters", "1", "--N_rand", "32",
        "--use_bspg", "False", *flags), SMALL)
    assert _ran(ev) == ran
