"""The port's LPIPS (``nerfool_tpu_torch/metrics/lpips.py``) against the JAX
package's, on the same images and the same random weights, which JAX's
``save_lpips_weights`` writes and both packages read; the weight files'
round trips between the packages; and the evaluators' recorded LPIPS.

The metric is held at rtol 1e-4, the JAX package's own engine bound
(``tests/test_engine.py::test_engine_lpips_full_path``): both packages run the
same float32 VGG16 on the CPU and differ only in the convolutions' summation
order. Sizes: 24x32 and the odd 27x37, whose max pools floor 27 -> 13 -> 6
-> 3 -> 1 rows, as GNT's 189x252 frame floors 189 -> 94.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfool_tpu.attack.engine import AdvEvaluator
from nerfool_tpu.metrics import lpips as j_lpips
from nerfool_tpu.models.bundle import create_model as j_create_model

from nerfool_tpu_torch import eval as port_eval
from nerfool_tpu_torch.metrics import lpips as t_lpips
from nerfool_tpu_torch.models.convert import params_from_flax

from tests.test_engine import _engine_args

torch.set_num_threads(2)

SMALL = {"n_views": 6, "h": 48, "w": 64}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Random LPIPS weights from JAX's init, written by JAX's
    ``save_lpips_weights``: (path, the flax tree)."""
    dummy = jnp.zeros((1, 8, 8, 3))
    params = j_lpips.LPIPS().init(jax.random.PRNGKey(0), dummy,
                                  dummy)["params"]
    params = jax.tree.map(np.asarray, params)
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_rand.npz")
    j_lpips.save_lpips_weights(params, path)
    return path, params


def _trees_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("hw", [(24, 32), (27, 37)])
def test_lpips_matches_jax(weights, normalize, hw):
    path, params = weights
    rng = np.random.RandomState(3)
    pred = rng.rand(2, *hw, 3).astype(np.float32)
    gt = rng.rand(2, *hw, 3).astype(np.float32)
    ref = np.asarray(j_lpips.LPIPS(normalize=normalize).apply(
        {"params": params}, jnp.asarray(pred), jnp.asarray(gt)))
    model = t_lpips.LPIPS(normalize).load_params(
        t_lpips.load_lpips_weights(path))
    with torch.no_grad():
        got = model(torch.as_tensor(pred), torch.as_tensor(gt)).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_lpips_weight_files_load_in_both_packages(weights, tmp_path):
    """``.npz`` JAX -> port and port -> JAX give the same tree; a ``.pth``
    of torchvision-indexed VGG features and pip-lpips lins goes through
    both packages' ``convert_lpips_torch_state`` to the same tree, and into
    the port's module as the weights it was written from."""
    path, params = weights
    _trees_equal(t_lpips.load_lpips_weights(path), params)

    torch.manual_seed(5)
    model = t_lpips.LPIPS()
    mine = str(tmp_path / "port.npz")
    t_lpips.save_lpips_weights(model.params(), mine)
    _trees_equal(j_lpips.load_lpips_weights(mine), model.params())
    back = t_lpips.LPIPS().load_params(t_lpips.load_lpips_weights(mine))
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              back.state_dict().items()):
        assert torch.equal(a, b), k

    vgg, ti = {}, 0  # torchvision's vgg16.features indices
    for b, (_, n_convs) in enumerate(t_lpips._VGG_BLOCKS):
        for c in range(n_convs):
            conv = getattr(model.vgg, f"conv{b}_{c}")
            vgg[f"{ti}.weight"] = conv.weight.detach().clone()
            vgg[f"{ti}.bias"] = conv.bias.detach().clone()
            ti += 2
        ti += 1
    lins = {f"lin{i}.model.1.weight": getattr(model, f"lin{i}").weight
            .detach().clone() for i in range(5)}
    pth = str(tmp_path / "lpips.pth")
    torch.save({"vgg_features": vgg, "lins": lins}, pth)
    tree = t_lpips.load_lpips_weights(pth)
    _trees_equal(tree, j_lpips.load_lpips_weights(pth))
    _trees_equal(tree, model.params())


@pytest.mark.parametrize("backbone", ["ibrnet", "gnt"])
def test_evaluator_lpips_matches_jax_under_the_backbones_convention(
        weights, tmp_path, backbone):
    """One clean view per backbone through both evaluators with
    ``--lpips_weights`` (per-tap renders, the same weights): the port's
    recorded ``coarse_lpips`` is finite, equals the JAX evaluator's at rtol
    1e-4, equals a direct recompute under the backbone's convention
    (IBRNet scales [0, 1] to [-1, 1], GNT feeds [0, 1] raw) and differs
    from the other convention's; without weights both levels read NaN."""
    from nerfool_tpu_torch.engine import Evaluator

    path, _ = weights
    gnt = backbone == "gnt"
    jb = j_create_model(backbone=backbone, trans_depth=2, single_net=gnt,
                        rng_key=jax.random.PRNGKey(4))
    ckpt = tmp_path / "model.pth"
    torch.save(params_from_flax(jax.tree.map(np.asarray, jb.params)), ckpt)
    kw = dict(backbone="gnt", trans_depth=2, ret_alpha=True) if gnt else {}
    args = _engine_args(tmp_path, view_specific=True, no_attack=True,
                        lpips_weights=path, **kw)
    ref = AdvEvaluator(args, bundle=jb, dataset_kwargs=SMALL).evaluate(
        verbose=False, save_images=False, max_views=1)["synthetic"]

    flags = ["--eval_dataset", "synthetic", "--N_samples", "12",
             "--N_importance", "0", "--chunk_size", "256",
             "--num_source_views", "4", "--rootdir", str(tmp_path),
             "--device", "cpu", "--max_views", "1", "--ckpt_path", str(ckpt)]
    flags += (["--backbone", "gnt", "--trans_depth", "2", "--ret_alpha"]
              if gnt else [])
    targs = port_eval.parse_args(flags + ["--lpips_weights", path])
    ev = Evaluator(targs, dataset_kwargs=SMALL, device="cpu")
    out = ev.evaluate(max_views=1, verbose=False)["synthetic"]
    data = ev.test_dataset[0]
    file_id = os.path.splitext(os.path.basename(data["rgb_path"]))[0]
    got = out[file_id]["coarse_lpips"]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref[file_id]["coarse_lpips"], rtol=1e-4)
    assert np.isnan(out[file_id]["fine_lpips"])  # N_importance 0

    with torch.inference_mode():
        pred = torch.clamp(ev.render_view(data, ev._make_src(data))
                           ["outputs_coarse"]["rgb"], 0, 1)[None]
    gt = torch.as_tensor(np.asarray(data["rgb"]))[None]
    expect = {}
    for conv in (True, False):
        m = t_lpips.LPIPS(conv).load_params(t_lpips.load_lpips_weights(path))
        with torch.no_grad():
            expect[conv] = float(m(pred, gt)[0])
    np.testing.assert_allclose(got, expect[not gnt], rtol=1e-6)
    assert abs(got - expect[gnt]) > 1e-6, (got, expect)

    none = port_eval.parse_args(flags + ["--lpips_weights", ""])
    row = Evaluator(none, dataset_kwargs=SMALL, device="cpu").evaluate(
        max_views=1, verbose=False)["synthetic"][file_id]
    assert np.isnan(row["coarse_lpips"]) and np.isnan(row["fine_lpips"])
