"""The port's image dumps (``nerfool_tpu_torch/utils/vis.py`` and the
evaluator's PNGs) against the JAX package's.

``colorize_np`` is matplotlib's ``jet`` written in numpy, so after ``to8b``
it equals the JAX package's (matplotlib) bit for bit, NaN included. The PNG
writer is checked by decoding with imageio (CPU only: the card's machine has
no imaging package). The evaluators' files of one clean view are compared
after decoding: the inputs (ground truth, the sources' average, the
perturbed sources under a zero delta) exactly; the renders, which the two
packages compute to ~1e-5 (tests/test_torch_render.py), within the one code
that truncation to 8 bits (or to whole millimetres for the uint16 depth)
can flip where a value lies that close to a code boundary, and the
colour-mapped maps within one step of jet's table, where such a flip moves
the table index by one.
"""
import os

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfool_tpu.attack.engine import AdvEvaluator
from nerfool_tpu.models.bundle import create_model as j_create_model
from nerfool_tpu.utils import vis as j_vis

from nerfool_tpu_torch import eval as port_eval
from nerfool_tpu_torch.models.convert import params_from_flax
from nerfool_tpu_torch.utils import vis

from tests.test_engine import _engine_args

torch.set_num_threads(2)

SMALL = {"n_views": 6, "h": 48, "w": 64}


def _image(kind):
    rng = np.random.RandomState(11)
    x = rng.rand(30, 40) * 3.0 - 0.5
    if kind == "nan":
        x[4, 5] = x[20, 30] = np.nan
    return x


@pytest.mark.parametrize("case", ["range", "mask", "percentile", "nan"])
def test_colorize_equals_jax_bit_for_bit(case):
    x = _image(case)
    mask = np.random.RandomState(12).rand(*x.shape) > 0.3
    kw = {"range": dict(range=(0.0, 2.0)), "mask": dict(mask=mask),
          "percentile": {}, "nan": dict(range=(0.0, 1.0))}[case]
    got = vis.to8b(vis.colorize_np(x, **kw))
    ref = j_vis.to8b(j_vis.colorize_np(x, **kw))
    assert got.shape == x.shape + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    if case == "nan":  # matplotlib's "bad" colour
        assert (got[4, 5] == 0).all()


@pytest.mark.parametrize("dtype,shape", [(np.uint8, (7, 9, 3)),
                                         (np.uint16, (7, 9))])
def test_write_png_decodes_to_the_array(tmp_path, dtype, shape):
    """8-bit RGB (the renders and maps) and 16-bit grey (the depth in
    millimetres); other layouts are refused."""
    a = np.random.RandomState(1).randint(0, np.iinfo(dtype).max + 1,
                                         size=shape).astype(dtype)
    path = str(tmp_path / "a.png")
    vis.write_png(path, a)
    got = imageio.imread(path)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, a)
    for bad in (np.zeros((4, 3, 3), np.uint16), np.zeros((4, 3), np.uint8)):
        with pytest.raises(ValueError, match="write_png"):
            vis.write_png(path, bad)


def _jet_step():
    """The largest change of a jet channel between neighbouring entries, in
    8-bit codes, plus the code that truncation adds."""
    return int(np.ceil(np.abs(np.diff(vis.JET_LUT[:256], axis=0)).max()
                       * 255)) + 1


@pytest.mark.parametrize("backbone", ["ibrnet", "gnt"])
def test_evaluator_dumps_match_jax(tmp_path, backbone):
    gnt = backbone == "gnt"
    jb = j_create_model(backbone=backbone, trans_depth=2, single_net=gnt,
                        rng_key=jax.random.PRNGKey(2))
    ckpt = tmp_path / "model.pth"
    torch.save(params_from_flax(jax.tree.map(np.asarray, jb.params)), ckpt)
    kw = dict(backbone="gnt", trans_depth=2, ret_alpha=True) if gnt else {}
    n_imp = "0" if gnt else "4"
    args = _engine_args(tmp_path, view_specific=True, no_attack=True,
                        export_adv_source_img=True, **kw)
    args.N_importance = int(n_imp)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    AdvEvaluator(args, bundle=jb, dataset_kwargs=SMALL).evaluate(
        out_dir=jdir, verbose=False, max_views=1)

    flags = ["--eval_dataset", "synthetic", "--N_samples", "12",
             "--N_importance", n_imp, "--chunk_size", "256",
             "--num_source_views", "4", "--rootdir", str(tmp_path),
             "--device", "cpu", "--ckpt_path", str(ckpt),
             "--export_adv_source_img"]
    flags += (["--backbone", "gnt", "--trans_depth", "2", "--ret_alpha"]
              if gnt else [])
    from nerfool_tpu_torch.engine import Evaluator
    ev = Evaluator(port_eval.parse_args(flags), dataset_kwargs=SMALL,
                   device="cpu")
    ev.evaluate(max_views=1, verbose=False, out_dir=tdir)

    pngs = lambda d: sorted(f for f in os.listdir(d) if f.endswith(".png"))
    names = pngs(jdir)
    assert names == pngs(tdir)
    levels = ("coarse",) if gnt else ("coarse", "fine")
    fid = os.path.splitext(os.path.basename(ev.test_dataset[0]["rgb_path"]))[0]
    expect = {f"{fid}_{k}.png" for k in ("gt_rgb", "average")}
    expect |= {f"{fid}_{k}_{lv}.png" for lv in levels for k in (
        "pred", "err_map", "depth", "depth_vis", "acc_map")}
    n_src = ev._make_src(ev.test_dataset[0])["rgbs"].shape[0]
    expect |= {f"adv_src_0_{j}.png" for j in range(n_src)}
    assert set(names) == expect
    assert {"args.txt"} <= set(os.listdir(tdir))

    step = _jet_step()
    for name in names:
        a = imageio.imread(os.path.join(tdir, name))
        b = imageio.imread(os.path.join(jdir, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
        if name.startswith("adv_src") or name.endswith(("gt_rgb.png",
                                                        "average.png")):
            bound = 0
        elif "_err_map_" in name or "_vis_" in name or "_acc_map_" in name:
            bound = step
        else:  # pred (8-bit codes), depth (uint16 millimetres)
            bound = 1
        assert diff.max() <= bound, (name, diff.max(), bound)
