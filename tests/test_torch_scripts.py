"""The port's command lines beyond eval, eval_adv and train, against the JAX
package's scripts: ``python -m nerfool_tpu_torch.render_video``, ``.sweep``,
``.verify_parity`` and ``.export_lpips_weights``, and the port's PNG reader,
which the LLFF loaders take where the card's machine has no imaging
package.

- render_video: the spiral of a generated LLFF scene (tests/test_data.py's
  ``_write_llff_scene``, as tests/test_engine.py drives the JAX script),
  from the JAX bundle's weights saved as a reference-layout checkpoint, at
  the coarse level only (24 samples): the first frame's PNG within one
  8-bit level of the JAX script's (the rendered rgb agrees to ~1e-5, which
  moves a rounding to 8 bits by at most one level; a fine level's
  inverse-CDF resampling turns such differences into 2 levels at a few
  pixels, the fine-level divergence of ROADMAP §3).
- sweep: two LLFF scenes (``SCENES`` patched), clean rows: the retargeted
  evaluator's rows on the second scene equal a fresh evaluator's exactly
  (the same weights and arithmetic; retarget dropped the first scene's
  state).
- verify_parity: the port's ``make_fixture`` checkpoint loads through
  ``--ckpt_path`` into the port's evaluator (its command line, in a
  subprocess, as the runbook runs it) and into the JAX evaluator; the clean
  coarse and fine PSNR / SSIM agree within 1e-3 dB / 1e-4
  (tests/test_torch_eval.py's bounds), and the runbook's ``verdict`` reads
  PASS on those rows. Without the reference checkout the runbook exits
  non-zero.
- export_lpips_weights: random state dicts of VGG16's and the lin heads'
  shapes give the same arrays as the JAX script.
"""
import importlib.util
import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import jax
import pytest
import torch

from test_data import _write_llff_scene

from nerfool_tpu.models.bundle import create_model as j_create_model

from nerfool_tpu_torch import export_lpips_weights, render_video, sweep
from nerfool_tpu_torch import verify_parity
from nerfool_tpu_torch.engine import Evaluator
from nerfool_tpu_torch.models.convert import params_from_flax
from nerfool_tpu_torch.utils.vis import read_png

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _png_with_filters(path, img):
    """``img`` (uint8 [H, W, C]) as a PNG whose row y uses filter y % 5."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    out = []
    for y in range(h):
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        kind = y % 5
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            pa, pb = np.abs(prev - ul), np.abs(left - ul)
            pc = np.abs(left + prev - 2 * ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        out.append(np.concatenate([[kind], (cur - pred) & 255]))
    raw = np.asarray(out, np.uint8).tobytes()
    chunk = lambda k, d: (struct.pack(">I", len(d)) + k + d
                          + struct.pack(">I", zlib.crc32(k + d) & 0xFFFFFFFF))
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_png_undoes_every_row_filter(tmp_path, channels):
    import imageio.v2 as imageio

    rng = np.random.RandomState(channels)
    img = np.cumsum(rng.randint(0, 40, (11, 13, channels)), axis=1).astype(
        np.uint8)
    _png_with_filters(tmp_path / "f.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "f.png"), img)
    ref = imageio.imread(tmp_path / "f.png")
    np.testing.assert_array_equal(read_png(tmp_path / "f.png").reshape(
        ref.shape), ref)


def test_imread_reads_png_without_imageio(tmp_path, monkeypatch):
    """The LLFF loaders' ``imread``: imageio where it imports, the port's
    PNG reader where it does not (as on a machine without imageio)."""
    from nerfool_tpu_torch.data.llff_utils import imread

    img = np.cumsum(np.random.RandomState(7).randint(0, 40, (9, 12, 3)),
                    axis=1).astype(np.uint8)
    _png_with_filters(tmp_path / "f.png", img)
    np.testing.assert_array_equal(imread(tmp_path / "f.png"), img)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    np.testing.assert_array_equal(imread(tmp_path / "f.png"), img)
    with pytest.raises(ImportError):
        imread(tmp_path / "f.jpg")


def test_render_video_first_frame_matches_jax(tmp_path, monkeypatch):
    _write_llff_scene(str(tmp_path))
    jb = j_create_model(backbone="ibrnet", rng_key=jax.random.PRNGKey(3))
    ckpt = tmp_path / "model.pth"
    torch.save(params_from_flax(jax.tree.map(np.asarray, jb.params)), ckpt)
    flags = ["--rootdir", str(tmp_path), "--llff_factor", "1",
             "--eval_scenes", "testscene", "--eval_dataset", "llff_test",
             "--N_samples", "24", "--N_importance", "0", "--chunk_size",
             "1920", "--num_source_views", "3", "--video_frames", "1",
             "--ckpt_path", str(ckpt)]
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "render_video.py"),
         *flags, "--expname", "vid"], cwd=str(jax_dir),
        env=dict(os.environ, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    port_dir = tmp_path / "port"
    port_dir.mkdir()
    monkeypatch.chdir(port_dir)
    try:
        out = render_video.main([*flags, "--expname", "vid", "--device",
                                 "cpu"])
    finally:
        log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log[-2000:]
    assert len(out["frames"]) == 1
    import imageio.v2 as imageio

    ref = imageio.imread(jax_dir / "llff_test" / "vid_video" / "testscene"
                         / "000.png")
    got = read_png(out["frames"][0])
    assert got.shape == ref.shape == (40, 48, 3)
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and diff.mean() < 0.01, (diff.max(), diff.mean())
    assert got.std() > 1  # a rendered frame, not a constant


def test_sweep_retarget_matches_a_fresh_evaluator(tmp_path, monkeypatch):
    _write_llff_scene(str(tmp_path))
    verify_parity.make_fixture(str(tmp_path), "ibrnet", h=32, w=40)
    monkeypatch.setitem(sweep.SCENES, "llff_test", ["testscene", "fixscene"])
    monkeypatch.chdir(tmp_path)
    argv = ["--rootdir", str(tmp_path), "--llff_factor", "1",
            "--eval_dataset", "llff_test", "--no_attack", "--view_specific",
            "--N_samples", "8", "--num_source_views", "3", "--chunk_size",
            "1024", "--device", "cpu", "--ckpt_path", "", "--max_views", "1",
            "--expname", "sw"]
    report = sweep.main(argv)
    assert sorted(report) == ["llff_test/fixscene", "llff_test/testscene"]
    with open(tmp_path / "llff_test" / "sw" / "sweep_report.json") as f:
        assert sorted(json.load(f)) == sorted(report)
    args = sweep.port_parser().parse_args(argv)
    args.eval_scenes = ["fixscene"]
    fresh = Evaluator(args, device="cpu").evaluate(
        max_views=1, verbose=False)["fixscene"]
    swept = report["llff_test/fixscene"]
    views = [k for k in fresh if isinstance(fresh[k], dict)]
    assert views and sorted(views) == sorted(
        k for k in swept if isinstance(swept[k], dict))
    for v in views:
        for k in ("coarse_psnr", "fine_psnr", "coarse_ssim", "fine_ssim"):
            assert swept[v][k] == fresh[v][k], (v, k)
            assert np.isfinite(swept[v][k])
    assert swept["coarse_mean_psnr"] != report[
        "llff_test/testscene"]["coarse_mean_psnr"]


def test_fixture_checkpoint_clean_rows_match_jax(tmp_path):
    from nerfool_tpu.attack.engine import AdvEvaluator
    from nerfool_tpu.config import config_parser as j_config_parser

    a = verify_parity.parse_args(["--workdir", str(tmp_path), "--device",
                                  "cpu", "--fixture", "--reference",
                                  str(tmp_path / "reference")])
    _, ckpt = verify_parity.make_fixture(a.workdir, "ibrnet")
    verify_parity.fixture_settings(a)
    flags = verify_parity.build_flags(a, "clean", ckpt)
    ours = verify_parity.run_ours(a, flags, "clean")
    jargs = j_config_parser().parse_args(flags + ["--backbone", "ibrnet"])
    jargs.distributed = False
    ref = AdvEvaluator(jargs).evaluate(save_images=False,
                                       verbose=False)["fixscene"]
    views = [k for k in ref if isinstance(ref[k], dict)]
    assert views and sorted(views) == sorted(
        k for k in ours if isinstance(ours[k], dict))
    for v in views:
        for level in ("coarse", "fine"):
            assert abs(ours[v][f"{level}_psnr"]
                       - ref[v][f"{level}_psnr"]) < 1e-3, (v, level)
            assert abs(ours[v][f"{level}_ssim"]
                       - ref[v][f"{level}_ssim"]) < 1e-4, (v, level)
    lines, ok = verify_parity.verdict([(
        "clean", verify_parity.metrics_of(ref, "fine"),
        verify_parity.metrics_of(ours, "fine"))])
    assert ok and lines[-1] == "VERDICT: PASS (clean parity within tolerance)"
    assert sum(" | PASS" in ln for ln in lines) == 2  # psnr and ssim


def test_fixture_of_either_backbone_loads_in_both_packages(tmp_path):
    from nerfool_tpu_torch.models.bundle import create_model

    for backbone in ("ibrnet", "gnt"):
        scene, ckpt = verify_parity.make_fixture(str(tmp_path / backbone),
                                                 backbone)
        images = "images_4" if backbone == "gnt" else "images"
        assert len(os.listdir(os.path.join(scene, images))) == 10
        assert read_png(os.path.join(scene, images, "im000.png")).shape == (
            40, 48, 3)
        kw = dict(trans_depth=2, single_net=True) if backbone == "gnt" else {}
        create_model(backbone=backbone, ckpt_path=ckpt, **kw)
        j_create_model(backbone=backbone, ckpt_path=ckpt, **kw)


def test_runbook_refuses_to_report_without_its_oracle(tmp_path, capsys):
    missing = tmp_path / "no_reference"
    with pytest.raises(SystemExit) as e:
        verify_parity.main(["--fixture", "--workdir", str(tmp_path / "vp"),
                            "--reference", str(missing)])
    assert e.value.code not in (0, None) and str(missing) in str(e.value.code)
    assert "VERDICT" not in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:  # --reference has no default
        verify_parity.main(["--fixture", "--workdir", str(tmp_path / "vp")])
    assert e.value.code == 2
    assert "--reference" in capsys.readouterr().err
    lines, ok = verify_parity.verdict([
        ("clean", {"psnr": 20.0, "ssim": 0.5, "lpips": float("nan")},
         {"psnr": 20.5, "ssim": 0.5, "lpips": float("nan")})])
    assert not ok and "FAIL" in lines[1]


def test_export_lpips_weights_matches_jax_script(tmp_path):
    from nerfool_tpu.metrics.lpips import save_lpips_weights as j_save

    rng = np.random.RandomState(0)
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
           "M", 512, 512, 512]
    vgg, c_in, i = {}, 3, 0
    for c in cfg:
        if c != "M":
            vgg[f"features.{i}.weight"] = torch.as_tensor(
                rng.randn(c, c_in, 3, 3).astype(np.float32))
            vgg[f"features.{i}.bias"] = torch.as_tensor(
                rng.randn(c).astype(np.float32))
            c_in = c
            i += 2
        else:
            i += 1
    vgg["classifier.0.weight"] = torch.zeros(4, 4)  # ignored
    lins = {f"lin{j}.model.1.weight": torch.as_tensor(
        rng.rand(1, c, 1, 1).astype(np.float32))
        for j, c in enumerate((64, 128, 256, 512, 512))}
    torch.save(vgg, tmp_path / "vgg16.pth")
    torch.save(lins, tmp_path / "vgg.pth")
    out = export_lpips_weights.main([
        "--vgg_pth", str(tmp_path / "vgg16.pth"), "--lpips_pth",
        str(tmp_path / "vgg.pth"), "--out", str(tmp_path / "port.npz")])
    spec = importlib.util.spec_from_file_location(
        "export_lpips_weights_jax",
        os.path.join(REPO, "scripts", "export_lpips_weights.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    j_save(script._params_from_local(str(tmp_path / "vgg16.pth"),
                                     str(tmp_path / "vgg.pth")),
           str(tmp_path / "jax.npz"))
    with np.load(out) as got, np.load(tmp_path / "jax.npz") as ref:
        assert sorted(got.files) == sorted(ref.files)
        assert len(got.files) == 13 * 2 + 5
        for k in ref.files:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    with pytest.raises(SystemExit):
        export_lpips_weights.main(["--vgg_pth", str(tmp_path / "vgg.pth"),
                                   "--lpips_pth", str(tmp_path / "vgg.pth")])
