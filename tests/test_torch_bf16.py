"""bf16 on the port's evaluator path against the JAX package on the CPU:
the feature net under ``--feature_dtype bfloat16`` and IBRNet under
``--compute_dtype bfloat16``.

The feature net is held as the JAX package holds its own
(tests/test_attack.py's noise-floor test, tests/test_attack_bf16.py): a
random-init ResUNet amplifies any rounding chaotically, so bf16 features are
not compared with f32 ones entrywise. Instead their deviation must stay
within three times the f32 net's own deviation under 2e-3 input noise, both
from the port's f32 features and from JAX's bf16 features; and the attack
on bf16 features must climb the rgb loss to a final value 0.7-1.4x the f32
attack's (20 iterations, as JAX's efficacy guard).

IBRNet in bf16 is held to the JAX f32 render of the same view: the port's
max error, on the per-tap route and on BSPG with bf16 patch tables, may be
at most twice the JAX bf16 render's own. Both round the same quantities to
bf16 (the aggregator's inputs and weights, relative error 2^-9) and run the
aggregator in bf16, so both lie at distances of one scale from the f32
render; where they round differs (PyTorch rounds each op's result and
accumulates reductions in f32, XLA rounds at the end of fused elementwise
chains; BSPG's taps interpolate bf16 texels where the per-tap route rounds
the interpolated value), which changes the error's pattern, not its scale,
and the factor 2 covers the spread of the frame maximum between two such
patterns. The bf16 attack step's gradient keeps the f32 step's direction
(cosine > 0.95, tests/test_attack.py's bound).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import synthetic_scene

from nerfool_tpu.attack import attack as j_attack
from nerfool_tpu.attack.engine import AdvEvaluator
from nerfool_tpu.models.bundle import create_model as j_create_model

from nerfool_tpu_torch import eval as port_eval
from nerfool_tpu_torch.attack import attack as t_attack
from nerfool_tpu_torch.models.bundle import create_model
from nerfool_tpu_torch.models.convert import params_from_flax
from nerfool_tpu_torch.render.render_rays import RenderConfig

from tests.test_engine import _engine_args
from tests.test_torch_attack import H, W, _render_cfgs, _scene, _t

torch.set_num_threads(2)

SMALL = {"n_views": 6, "h": 48, "w": 64}


def _state_dicts(jb):
    return params_from_flax(jax.tree.map(np.asarray, jb.params))


def test_bf16_features_stay_inside_the_f32_noise_envelope():
    rng = np.random.RandomState(1234)
    _, src_rgbs, _, _, _ = synthetic_scene(rng, n_src=3, h=H, w=W)
    jbf = j_create_model(backbone="ibrnet", rng_key=jax.random.PRNGKey(11),
                         feature_dtype="bfloat16")
    sd = _state_dicts(jbf)
    t32 = create_model(backbone="ibrnet", state_dicts=sd)
    tbf = create_model(backbone="ibrnet", state_dicts=sd,
                       feature_dtype="bfloat16")
    seen = []
    tbf.feature_net.conv1.register_forward_hook(
        lambda m, i, o: seen.append((i[0].dtype, o.dtype)))
    x = torch.as_tensor(src_rgbs)
    noise = 2e-3 * np.random.RandomState(3).randn(*src_rgbs.shape)
    with torch.no_grad():
        f32 = t32.extract_features(x)
        fbf = tbf.extract_features(x)
        fn = t32.extract_features(x + torch.as_tensor(noise, dtype=x.dtype))
    assert seen == [(torch.bfloat16, torch.bfloat16)]
    jf = jbf.extract_features(jnp.asarray(src_rgbs))
    for lv in range(2):
        assert fbf[lv].dtype == torch.float32
        assert bool(torch.isfinite(fbf[lv]).all())
        env = float((f32[lv] - fn[lv]).abs().max())
        bound = 3.0 * max(env, 1e-3)
        err = float((f32[lv] - fbf[lv]).abs().max())
        cross = float(np.abs(fbf[lv].numpy() - np.asarray(jf[lv])).max())
        assert 0 < err < bound, (lv, err, env)
        assert cross < bound, (lv, cross, env)


def _run_attack(feature_dtype, iters=20):
    """The port's Adam attack on rgb (tests/test_attack_bf16.py's fixture),
    the rays drawn from one seeded generator in both runs."""
    rng = np.random.RandomState(7)
    h, w = 24, 32
    target_cam, src_rgbs, src_cams, _, depth_range = synthetic_scene(
        rng, n_src=3, h=h, w=w)
    target_rgb = rng.rand(h * w, 3).astype(np.float32)
    jb = j_create_model(backbone="ibrnet", rng_key=jax.random.PRNGKey(0))
    tb = create_model(backbone="ibrnet", state_dicts=_state_dicts(jb),
                      feature_dtype=feature_dtype)
    cfg = t_attack.AttackConfig(h=h, w=w, n_rand=64, use_adam=True,
                                adam_lr=1e-3, epsilon=8.0, adv_iters=iters)
    step = t_attack.make_attack_step(
        tb, RenderConfig(n_samples=12, backbone="ibrnet"), cfg)
    target = {"camera": _t(target_cam), "rgb": _t(target_rgb),
              "depth": None, "depth_range": _t(depth_range)}
    src = {"rgbs": _t(src_rgbs), "cameras": _t(src_cams),
           "featmaps_clean": None}
    gen = torch.Generator().manual_seed(1)
    state = t_attack.init_attack_state(gen, cfg, src["rgbs"])
    losses = []
    for _ in range(iters):
        state, aux = step(state, target, src, generator=gen)
        losses.append(float(aux["loss"]))
    assert float(state["delta"].abs().max()) <= 8.0 / 255.0 + 1e-7
    return np.array(losses)


def test_bf16_feature_attack_efficacy():
    f32 = _run_attack("float32")
    bf16 = _run_attack("bfloat16")
    assert f32[-1] > f32[0] * 1.05, (f32[0], f32[-1])
    assert bf16[-1] > bf16[0] * 1.05, (bf16[0], bf16[-1])
    ratio = bf16[-5:].mean() / f32[-5:].mean()
    assert 0.7 < ratio < 1.4, ratio


def test_bf16_ibrnet_render_within_derived_bound(tmp_path):
    """One view at 48x64, 12 + 4 samples, both levels: the port's bf16
    renders per tap and on BSPG (bf16 tables) against JAX's f32 one."""
    from nerfool_tpu_torch.engine import Evaluator

    jb = j_create_model(backbone="ibrnet", rng_key=jax.random.PRNGKey(0))
    renders = {}
    for dtype in ("float32", "bfloat16"):
        args = _engine_args(tmp_path, view_specific=True, no_attack=True,
                            compute_dtype=dtype, N_importance=4)
        ev = AdvEvaluator(args, bundle=jb, dataset_kwargs=SMALL)
        data = ev.test_dataset[0]
        src = ev._make_src(data)
        ret = ev.render_view(data, jnp.zeros_like(src["rgbs"]), src,
                             src["cameras"])
        renders[dtype] = {lv: {k: np.asarray(ret[lv][k], np.float32)
                               for k in ("rgb", "depth")}
                          for lv in ("outputs_coarse", "outputs_fine")}
    sd = _state_dicts(jb)
    for bspg in ("False", "True"):
        args = port_eval.parse_args([
            "--eval_dataset", "synthetic", "--N_samples", "12",
            "--N_importance", "4", "--chunk_size", "256",
            "--num_source_views", "4", "--rootdir", str(tmp_path),
            "--device", "cpu", "--compute_dtype", "bfloat16",
            "--use_bspg", bspg])
        tev = Evaluator(args, dataset_kwargs=SMALL, device="cpu",
                        bundle=create_model(args=args, state_dicts=sd))
        data = tev.test_dataset[0]
        cfg = tev.view_render_cfg(len(data["src_cameras"]))
        assert (cfg.bspg_specs is not None) == (bspg == "True")
        with torch.inference_mode():
            ret = tev.render_view(data, tev._make_src(data))
        for lv in ("outputs_coarse", "outputs_fine"):
            for k in ("rgb", "depth"):
                ref = renders["float32"][lv][k]
                err_j = float(np.abs(renders["bfloat16"][lv][k] - ref).max())
                got = ret[lv][k].float().numpy()
                assert got.dtype == np.float32 and np.isfinite(got).all()
                err_t = float(np.abs(got - ref).max())
                assert 0 < err_t <= 2.0 * err_j, (bspg, lv, k, err_t, err_j)


def test_bf16_ibrnet_attack_step_keeps_the_gradient_direction():
    """One Adam step on every pixel of the view (n_rand = H * W, as
    tests/test_attack.py's bf16 check) with the aggregator in bf16 and in
    f32 from the same delta0 and rays: the gradients (Adam's first moments)
    at cosine > 0.95, the bf16 one also against JAX's f32 step's."""
    rng = np.random.RandomState(7)
    jb, tb, target, src, delta0 = _scene(rng, "ibrnet")
    jr, tr = _render_cfgs("ibrnet")
    cfg = t_attack.AttackConfig(h=H, w=W, n_rand=H * W, use_adam=True,
                                adam_lr=1e-3)
    jcfg = j_attack.AttackConfig(h=H, w=W, n_rand=H * W, use_adam=True,
                                 adam_lr=1e-3)
    key = jax.random.PRNGKey(2)
    sel = np.asarray(j_attack.select_ray_indices(jax.random.split(key, 3)[0],
                                                 jcfg))
    jsrc = {k: jnp.asarray(v) for k, v in src.items()}
    jsrc["featmaps_clean"] = jb.extract_features(jsrc["rgbs"])
    jstate = dict(j_attack.init_attack_state(jax.random.PRNGKey(1), jcfg,
                                             jsrc["rgbs"]),
                  delta=jnp.asarray(delta0))
    jstate, _ = jax.jit(j_attack.make_attack_step(jb, jr, jcfg))(
        jstate, {k: jnp.asarray(v) for k, v in target.items()}, jsrc, key)
    ref = np.asarray(jstate["opt_state"][0].mu[0]).ravel()

    tsrc = {k: _t(v) for k, v in src.items()}
    tsrc["featmaps_clean"] = None
    ms = {}
    for dtype in ("float32", "bfloat16"):
        state = t_attack.init_attack_state(None, cfg, tsrc["rgbs"],
                                           delta=_t(delta0))
        state, aux = t_attack.make_attack_step(
            tb, dataclasses.replace(tr, compute_dtype=dtype), cfg)(
            state, {k: _t(v) for k, v in target.items()}, tsrc, sel=_t(sel))
        assert np.isfinite(float(aux["loss"]))
        ms[dtype] = state["m"].numpy().ravel()
    cos = lambda a, b: float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos(ms["float32"], ms["bfloat16"]) > 0.95
    assert cos(ref, ms["bfloat16"]) > 0.95
    assert cos(ref, ms["float32"]) > 0.99
