"""How the port's evaluator picks the whole-frame render route, against the
JAX evaluator on the same weights and views.

Where no BSPG plan can serve a render, the port renders per tap and prints
one line naming the reason, as the JAX evaluator warns and renders per tap:
a loader without ``target_cameras()``, and a frame of another size than the
planned one. A ``chunk_size`` that is not a multiple of the ray block is
rounded down to one on the BSPG route (``configs/gnt/gnt_full.txt``'s 800
with 8x8 blocks: 768), which leaves every ray's render as it was. Coarse
PSNR is held to 1e-3 dB and SSIM to 1e-4 of the JAX evaluator's rows, as in
test_torch_eval.py. ``--gnt_fused_vt auto`` resolves to on for a CUDA
device only.
"""
import json

import numpy as np
import jax
import pytest
import torch

from tests.test_engine import _engine_args

from nerfool_tpu.attack.engine import AdvEvaluator
from nerfool_tpu.data import dataset_dict as j_dataset_dict
from nerfool_tpu.models.bundle import create_model as j_create_model

from nerfool_tpu_torch import eval as port_eval
from nerfool_tpu_torch import eval_adv as port_eval_adv
from nerfool_tpu_torch.data import dataset_dict
from nerfool_tpu_torch.engine import Evaluator
from nerfool_tpu_torch.models.convert import params_from_flax
from nerfool_tpu_torch.render import render_image

# the test tier runs several worker processes on a few cores: two math
# threads per process instead of one per core keeps them from thrashing
torch.set_num_threads(2)

SMALL = {"n_views": 6, "h": 48, "w": 64}
OTHER = {"n_views": 6, "h": 40, "w": 56}  # a second frame size
GNT_FLAGS = ("--backbone", "gnt", "--trans_depth", "2", "--ret_alpha")


class _NoCameras:
    """A loader that exposes its views but no ``target_cameras()``."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]


def _port(tmp_path, ckpt, *extra):
    argv = ["--eval_dataset", "synthetic", "--N_samples", "12",
            "--N_importance", "0", "--chunk_size", "256",
            "--num_source_views", "4", "--rootdir", str(tmp_path),
            "--device", "cpu", "--dataset_kwargs", json.dumps(SMALL),
            "--ckpt_path", str(ckpt), "--use_bspg", "True", *extra]
    return Evaluator(port_eval.parse_args(argv), dataset_kwargs=SMALL,
                     device="cpu", seed=0)


def _jax(tmp_path, monkeypatch, jb, **overrides):
    monkeypatch.setenv("NERFOOL_FORCE_BSPG", "1")
    args = _engine_args(tmp_path, view_specific=True, no_attack=True,
                        **overrides)
    return AdvEvaluator(args, bundle=jb, dataset_kwargs=SMALL)


def _ckpt(tmp_path, jb, name):
    path = tmp_path / name
    torch.save(params_from_flax(jax.tree.map(np.asarray, jb.params)), path)
    return path


def _src_cameras(ev):
    """The source cameras of the evaluator's first test view."""
    return ev.test_dataset[0]["src_cameras"]


def _same_rows(out, ref):
    views = [k for k in ref if k.startswith("synthetic_")]
    assert views and sorted(views) == sorted(
        k for k in out if k.startswith("synthetic_"))
    for k in views:
        assert abs(out[k]["coarse_psnr"] - ref[k]["coarse_psnr"]) < 1e-3, k
        assert abs(out[k]["coarse_ssim"] - ref[k]["coarse_ssim"]) < 1e-4, k


@pytest.fixture(scope="module")
def ibr_bundle():
    return j_create_model(backbone="ibrnet", rng_key=jax.random.PRNGKey(0))


def test_loader_without_target_cameras_renders_per_tap(tmp_path, monkeypatch,
                                                       capsys, ibr_bundle):
    jev = _jax(tmp_path, monkeypatch, ibr_bundle)
    jev.test_dataset = _NoCameras(jev.test_dataset)
    with pytest.warns(UserWarning, match="target_cameras"):
        ref = jev.evaluate(verbose=False, save_images=False)["synthetic"]

    ev = _port(tmp_path, _ckpt(tmp_path, ibr_bundle, "ibr.pth"))
    ev.test_dataset = _NoCameras(ev.test_dataset)
    capsys.readouterr()
    out = ev.evaluate(verbose=False)["synthetic"]
    assert ev.view_render_cfg(len(_src_cameras(ev))).bspg_specs is None
    said = capsys.readouterr().out.splitlines()
    assert said == ["whole-frame renders take the per-tap gather: "
                    "_NoCameras exposes no target_cameras()"]
    _same_rows(out, ref)


def test_frame_of_another_size_renders_per_tap(tmp_path, monkeypatch, capsys,
                                               ibr_bundle):
    """Both evaluators plan on the 48x64 camera set, then render the views
    of a 40x56 one."""
    jev = _jax(tmp_path, monkeypatch, ibr_bundle)
    n_src = len(jev.test_dataset[0]["src_cameras"])
    assert jev._view_render_cfg(n_src).bspg_specs is not None
    jev.test_dataset = j_dataset_dict["synthetic"](
        jev.args, "test", scenes=jev.args.eval_scenes, **OTHER)
    ref = jev.evaluate(verbose=False, save_images=False)["synthetic"]

    ev = _port(tmp_path, _ckpt(tmp_path, ibr_bundle, "ibr.pth"))
    assert ev.view_render_cfg(n_src).bspg_specs is not None
    ev.test_dataset = dataset_dict["synthetic"](
        ev.args, "test", scenes=ev.args.eval_scenes, **OTHER)
    capsys.readouterr()
    out = ev.evaluate(verbose=False)["synthetic"]
    said = capsys.readouterr().out.splitlines()
    assert said == ["whole-frame renders take the per-tap gather: the BSPG "
                    "plan covers 48x64 frames, not 40x56"]
    _same_rows(out, ref)


def test_chunk_of_800_rounds_down_to_whole_blocks(tmp_path, monkeypatch,
                                                  capsys):
    """GNT at ``gnt_full.txt``'s chunk of 800 with 8x8 blocks: chunks of 768
    rays on BSPG, said once, the same frame as with chunks of 4096 and the
    JAX evaluator's rows (its BSPG route needs whole blocks, so it renders
    per tap)."""
    jb = j_create_model(backbone="gnt", trans_depth=2, single_net=True,
                        rng_key=jax.random.PRNGKey(4))
    jev = AdvEvaluator(_engine_args(
        tmp_path, view_specific=True, no_attack=True, backbone="gnt",
        trans_depth=2, ret_alpha=True, chunk_size=800), bundle=jb,
        dataset_kwargs=SMALL)
    ref = jev.evaluate(verbose=False, save_images=False)["synthetic"]

    ckpt = _ckpt(tmp_path, jb, "gnt.pth")
    render_image._said_chunks.clear()
    frames = {}
    for chunk in (800, 4096):
        ev = _port(tmp_path, ckpt, *GNT_FLAGS, "--chunk_size", str(chunk))
        assert ev.view_render_cfg(len(_src_cameras(ev))).bspg_specs[0].block \
            == (8, 8)
        capsys.readouterr()
        out = ev.evaluate(verbose=False)["synthetic"]
        said = capsys.readouterr().out.splitlines()
        assert said == ([
            "chunk_size 800 is not a multiple of the 8x8 ray block: BSPG "
            "renders take chunks of 768 rays"] if chunk == 800 else [])
        _same_rows(out, ref)
        data = ev.test_dataset[0]
        with torch.inference_mode():
            frames[chunk] = ev.render_view(
                data, ev._make_src(data))["outputs_coarse"]
    assert capsys.readouterr().out == ""  # said once
    for k in ("rgb", "depth", "weights"):
        torch.testing.assert_close(frames[800][k], frames[4096][k],
                                   rtol=1e-5, atol=1e-6)


def test_fused_vt_auto_resolves_by_device(tmp_path):
    ev = _port(tmp_path, "", *GNT_FLAGS, "--use_bspg", "False")
    assert ev.args.gnt_fused_vt == "auto"
    assert not ev.view_render_cfg(4).gnt_fused_vt
    ev.device = torch.device("cuda")  # resolution only: nothing is launched
    assert ev.view_render_cfg(4).gnt_fused_vt
    assert not ev._grad_render_cfg().gnt_fused_vt
    for mode, want in (("off", False), (False, False), ("on", True)):
        ev.args.gnt_fused_vt = mode
        assert ev.view_render_cfg(4).gnt_fused_vt is want
    ev.args.backbone = "ibrnet"
    assert not ev.view_render_cfg(4).gnt_fused_vt


def test_bspg_chain_route_fills_the_chains_input_in_place(tmp_path,
                                                          monkeypatch):
    """On the BSPG route of a bf16 GNT render through the whole chain, the
    selection writes the taps, and the render the ray differences and the
    mask, straight into the chain's [V, R, S, 3 + c + 5] input: it equals
    their concatenation, and the aggregator's rgb_feat is a view of it."""
    from nerfool_tpu_torch.ops import chain

    seen = []
    real = chain.fused_chain_aggregate

    def spy(net, rgb_feat, ray_diff, mask, pts, ray_d, merged=None):
        seen.append((rgb_feat, ray_diff, mask, merged))
        return real(net, rgb_feat, ray_diff, mask, pts, ray_d, merged)

    monkeypatch.setattr(chain, "fused_chain_aggregate", spy)
    ev = _port(tmp_path, "", *GNT_FLAGS, "--compute_dtype", "bfloat16",
               "--gnt_fused_chain", "on")
    data = ev.test_dataset[0]
    assert ev.view_render_cfg(len(_src_cameras(ev))).bspg_specs is not None
    with torch.inference_mode():
        ev.render_view(data, ev._make_src(data))
    assert seen
    for rgb_feat, ray_diff, mask, merged in seen:
        assert merged is not None and merged.dtype == torch.bfloat16
        assert rgb_feat.data_ptr() == merged.data_ptr()
        want = torch.cat([rgb_feat, ray_diff.to(merged.dtype),
                          mask.to(merged.dtype)], dim=-1)
        assert torch.equal(merged, want)


def test_default_route_is_per_tap(tmp_path, capsys):
    """Without ``--use_bspg True`` whole-frame renders take the per-tap
    gather, plan nothing and say nothing; with it they take BSPG."""
    argv = ["--eval_dataset", "synthetic", "--num_source_views", "4",
            "--rootdir", str(tmp_path), "--device", "cpu", "--dataset_kwargs",
            json.dumps(SMALL), "--ckpt_path", ""]
    for parse in (port_eval.parse_args, port_eval_adv.parse_args):
        assert parse(argv).use_bspg is False
    ev = Evaluator(port_eval.parse_args(argv), dataset_kwargs=SMALL,
                   device="cpu", seed=0)
    assert ev.view_render_cfg(4).bspg_specs is None and not ev._bspg_specs
    ev.args.use_bspg = True
    assert ev.view_render_cfg(4).bspg_specs is not None
    assert capsys.readouterr().out == ""
