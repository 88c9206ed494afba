"""The port's trainer (``nerfool_tpu_torch/train``) and stochastic sampling
against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages; weights are the
JAX bundle's, carried over by ``convert.params_from_flax``. JAX keys and
torch generators never agree bit for bit, so the port is handed the draws
JAX makes from its keys: the ray indices, the jitter of the coarse depths,
the fine quantiles, the adversarial ``delta``'s start (each drawn in the
precision the JAX step runs in: x64 changes ``jax.random``'s bits).

Tolerances: stochastic sampling 1e-6 relative (the same f32 formulas, bit
for bit where the operations are the same; the fine depths in float64 to
1e-12, see their test); one train step in float64 (JAX under
``jax.enable_x64``) at the attack step's float64 bounds, loss 1e-7, every
parameter's gradient 1e-7 of its scale and every parameter after the Adam
update 1e-7 of its scale, plus where Adam's normalisation is ill
conditioned (|g| near its eps) the gradient's difference carried through
it (see the test); the same step in f32 at the attack step's gates (loss 1e-4,
gradient cosine > 0.99 per parameter group: the deep InstanceNorm backward
amplifies f32 rounding, ROADMAP §3); the adversarial inner loop in float64
at tests/test_advtrain_trajectory_x64.py's bounds (cosine > 0.9999, fewer
than 1% of entries apart); the learning rates against optax's schedule to
f32 rounding (optax computes them in f32).
"""
import contextlib
import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tests.test_torch_attack import H, W, _scene, _t

from nerfool_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from nerfool_tpu.models.bundle import create_model as j_create_model
from nerfool_tpu.render import sampling as jsamp
from nerfool_tpu.render.render_rays import RenderConfig as JRenderConfig
from nerfool_tpu.train import trainer as j_trainer
from nerfool_tpu.utils.logging import ScalarLogger as JScalarLogger

from nerfool_tpu_torch.data.synthetic import SyntheticDataset
from nerfool_tpu_torch.models import convert
from nerfool_tpu_torch.models.bundle import create_model
from nerfool_tpu_torch.models.convert import params_from_flax
from nerfool_tpu_torch.render import sampling as tsamp
from nerfool_tpu_torch.render.render_rays import RenderConfig
from nerfool_tpu_torch.train import trainer as t_trainer
from nerfool_tpu_torch.utils.logging import ScalarLogger

# the test tier runs several worker processes on a few cores: two math
# threads per process instead of one per core keeps them from thrashing
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- stochastic sampling ----

def _rays(rng, n=40):
    o = (rng.rand(n, 3) - 0.5).astype(np.float32)
    d = (rng.rand(n, 3) - 0.5).astype(np.float32) + np.float32([0, 0, 1])
    return o, d


@pytest.mark.parametrize("inv_uniform", [False, True])
def test_stochastic_coarse_samples_match_jax(inv_uniform):
    """The jitter between midpoints, JAX's uniform draw handed in: the same
    f32 operations, bit for bit."""
    o, d = _rays(np.random.RandomState(0))
    dr = np.array([[2.0, 6.0]], np.float32)
    key = jax.random.PRNGKey(4)
    jp, jz = jsamp.sample_along_camera_ray(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(dr), 16,
        inv_uniform=inv_uniform, det=False, key=key)
    t_rand = np.asarray(jax.random.uniform(key, (40, 16)))
    tp, tz = tsamp.sample_along_camera_ray(
        _t(o), _t(d), _t(dr), 16, inv_uniform=inv_uniform, det=False,
        t_rand=_t(t_rand))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    # jittered inside the strata: ascending, inside [near, far], off the grid
    z = tz.numpy()
    assert (np.diff(z, axis=-1) >= 0).all()
    assert z.min() >= 2.0 - 1e-6 and z.max() <= 6.0 + 1e-6
    det = tsamp.sample_along_camera_ray(_t(o), _t(d), _t(dr), 16,
                                        inv_uniform=inv_uniform)[1].numpy()
    assert np.abs(z - det).max() > 1e-3
    # a generator draws the same shape, and differently per seed
    g = [tsamp.sample_along_camera_ray(
        _t(o), _t(d), _t(dr), 16, inv_uniform=inv_uniform, det=False,
        generator=torch.Generator().manual_seed(s))[1] for s in (0, 0, 1)]
    torch.testing.assert_close(g[0], g[1], rtol=0, atol=0)
    assert float((g[0] - g[2]).abs().max()) > 1e-3


def test_stochastic_sample_pdf_matches_jax():
    rng = np.random.RandomState(1)
    bins = np.sort(rng.uniform(2, 6, (50, 17)), axis=-1).astype(np.float32)
    weights = rng.rand(50, 16).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 12,
                           det=False, key=key)
    u = np.asarray(jax.random.uniform(key, (50, 12)))
    got = tsamp.sample_pdf(_t(bins), _t(weights), 12, det=False, u=_t(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    with pytest.raises(ValueError, match="shape"):
        tsamp.sample_pdf(_t(bins), _t(weights), 12, det=False,
                         u=_t(u[:, :5]))


@pytest.mark.parametrize("inv_uniform", [False, True])
def test_stochastic_fine_zvals_match_jax(inv_uniform):
    """The fine depths at JAX's uniform quantiles, in float64: in f32 the
    two packages' cumsums of the pdf round in different orders, which 1/z
    amplifies to 2e-6 relative (tests/test_torch_geometry.py's deterministic
    hold allows 1e-5 for it); float64 takes that rounding out."""
    rng = np.random.RandomState(2)
    o, d = _rays(rng)
    dr = np.array([[2.0, 6.0]])
    weights = rng.rand(40, 16)
    with jax.enable_x64(True):
        _, z = jsamp.sample_along_camera_ray(
            jnp.asarray(o, jnp.float64), jnp.asarray(d, jnp.float64),
            jnp.asarray(dr), 16, inv_uniform=inv_uniform, det=True)
        key = jax.random.PRNGKey(9)
        ref = np.asarray(jsamp.sample_fine_zvals(
            z, jnp.asarray(weights), 8, inv_uniform=inv_uniform, det=False,
            key=key))
        u = np.asarray(jax.random.uniform(key, (40, 8), jnp.float64))
        z = np.asarray(z)
    assert ref.dtype == np.float64
    got = tsamp.sample_fine_zvals(_t(z), _t(weights), 8,
                                  inv_uniform=inv_uniform, det=False,
                                  u=_t(u))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)
    det = tsamp.sample_fine_zvals(_t(z), _t(weights), 8,
                                  inv_uniform=inv_uniform)
    assert float((got - det).abs().max()) > 1e-3


# ---- one train step against JAX ----

@contextlib.contextmanager
def _convert_in(dtype):
    """``params_from_flax`` keeping ``dtype`` (it writes float32)."""
    old = convert._t
    convert._t = lambda x: torch.from_numpy(np.array(x, dtype=dtype))
    try:
        yield
    finally:
        convert._t = old


def _train_cfgs(backbone, **cfg_kw):
    """(JAX render config, port render config, TrainConfig kwargs) with
    stochastic sampling."""
    if backbone == "ibrnet":
        jr = JRenderConfig(n_samples=12, n_importance=8, det=False,
                           backbone="ibrnet")
        tr = RenderConfig(n_samples=12, n_importance=8, det=False,
                          backbone="ibrnet")
    else:
        jr = JRenderConfig(n_samples=10, det=False, backbone="gnt",
                           single_net=True, ret_alpha=True,
                           stop_camera_grad=False)
        tr = RenderConfig(n_samples=10, det=False, backbone="gnt",
                          single_net=True, ret_alpha=True,
                          stop_camera_grad=False)
    kw = dict(h=H, w=W, n_rand=32, lrate_feature=1e-3, lrate_mlp=5e-4)
    kw.update(cfg_kw)
    return jr, tr, kw


def _jax_render_draws(key, jr, n_rays, dtype):
    """The sampling draws ``render_rays`` makes from ``key``:
    split(key, 4)[0] jitters the coarse depths, [2] the fine quantiles."""
    keys = jax.random.split(key, 4)
    coarse = np.asarray(jax.random.uniform(keys[0], (n_rays, jr.n_samples),
                                           dtype))
    fine = (np.asarray(jax.random.uniform(keys[2],
                                          (n_rays, jr.n_importance), dtype))
            if jr.n_importance else None)
    return {"samples": (_t(coarse), None if fine is None else _t(fine)),
            "noise": None}


def _batch(target, src):
    return {"camera": target["camera"], "rgb": target["rgb"],
            "depth_range": target["depth_range"], "src_rgbs": src["rgbs"],
            "src_cameras": src["cameras"]}


def _step_both(backbone, f64, **cfg_kw):
    """One train step of each package from the same weights and draws:
    (JAX loss, JAX gradients and updated parameters as the port's state
    dicts, the port's aux, gradients and updated parameters by module and
    name)."""
    rng = np.random.RandomState(7)
    jb, tb, target, src, _ = _scene(rng, backbone)
    jr, tr, kw = _train_cfgs(backbone, **cfg_kw)
    np_dt = np.float64 if f64 else np.float32
    if f64:
        jr = dataclasses.replace(jr, compute_dtype="float64")
    cast = lambda d: {k: v.astype(np_dt) if v.dtype.kind == "f" else v
                      for k, v in d.items()}
    batch = _batch(cast(target), cast(src))
    jcfg = j_trainer.TrainConfig(**kw)
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(f64):
        params = jax.tree.map(lambda a: jnp.asarray(a, np_dt), jb.params)
        jb = dataclasses.replace(jb, params=params)
        step, opt = j_trainer.make_train_step(jb, jr, jcfg)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        k_sel, _, k_render = jax.random.split(key, 3)
        sel = np.asarray(j_trainer._select_rays(k_sel, jcfg))
        draws = {"sel": _t(sel),
                 "outer": _jax_render_draws(k_render, jr, len(sel), np_dt)}
        # the step's own loss and optimizer, jitted once: step() is
        # value_and_grad(render_loss) then opt.update
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda p: step.render_loss(p, jbatch["src_rgbs"], jbatch,
                                       jnp.asarray(sel), k_render),
            has_aux=True))(params)
        new_params = jax.jit(lambda g, p: optax.apply_updates(
            p, opt.update(g, opt.init(p), p)[0]))(jgrads, params)
        with _convert_in(np_dt):
            jg = params_from_flax(jax.tree.map(np.asarray, jgrads))
            jnew = params_from_flax(jax.tree.map(np.asarray, new_params))
    modules = {"feature_net": tb.feature_net, "net_coarse": tb.net_coarse,
               "net_fine": tb.net_fine}
    if f64:
        for m in modules.values():
            if m is not None:
                m.double()
    tstep, _, _ = t_trainer.make_train_step(tb, tr, t_trainer.TrainConfig(
        **kw))
    tbatch = {k: _t(v) for k, v in batch.items()}
    taux, tgrads = tstep.loss_and_grads(tbatch, draws)
    by_param = dict(zip(map(id, tstep.params), tgrads))
    tstep(tbatch, draws=draws)
    grads, after = {}, {}
    for name, m in modules.items():
        if m is None:
            continue
        for pname, p in m.named_parameters():
            grads[name, pname] = by_param[id(p)].detach().numpy()
            after[name, pname] = p.detach().numpy()
    return float(jloss), jg, jnew, taux, grads, after


@pytest.mark.parametrize("backbone", ["ibrnet", "gnt"])
def test_train_step_float64_matches_jax(backbone):
    """IBRNet with a fine level (N_importance 8) and the depth-variance
    regularizer, GNT with ``single_net``: the loss, every parameter's
    gradient and every parameter after Adam's update. GNT computes its
    positional encodings of float64 points in float32 in both packages, as
    the attack step's float64 hold does."""
    kw = {"depth_var_loss": 0.1} if backbone == "ibrnet" else {}
    jloss, jg, jnew, taux, grads, after = _step_both(backbone, True, **kw)
    assert taux["loss"].dtype == torch.float64
    np.testing.assert_allclose(float(taux["loss"]), jloss, rtol=1e-7)
    assert set(grads) == {(m, n) for m in jg for n in jg[m]}
    top = max(np.abs(jg[m][n].numpy()).max() for m, n in grads)
    for (m, n), g in grads.items():
        ref = jg[m][n].numpy().reshape(g.shape)
        # a tensor whose gradient is zero in exact arithmetic (a conv bias
        # ahead of an InstanceNorm, which removes it) holds rounding noise
        # of ~1e-17 alone: its scale is at least 1e-6 of the largest
        scale = max(np.abs(ref).max(), 1e-6 * top)
        np.testing.assert_allclose(g, ref, rtol=0, atol=1e-7 * scale,
                                   err_msg=f"{m}.{n}")
        # Adam's first update is lr * g / (|g| + 1e-8), whose slope in g
        # is lr * 1e-8 / (|g| + 1e-8)^2, up to lr / 1e-8 near g = 0: a
        # parameter may differ by that slope times its gradient's
        # difference beside 1e-7 of its scale (or of lr, for a parameter
        # that starts at zero)
        lr = 1e-3 if m == "feature_net" else 5e-4
        least = np.where(np.sign(g) == np.sign(ref),
                         np.minimum(np.abs(g), np.abs(ref)), 0.0)
        slope = lr * 1e-8 / (least + 1e-8) ** 2
        new = jnew[m][n].numpy().reshape(g.shape)
        tol = 1e-7 * max(np.abs(new).max(), lr) + slope * np.abs(g - ref)
        bad = np.abs(after[m, n] - new) > tol
        assert not bad.any(), (f"{m}.{n} after Adam", np.abs(
            after[m, n] - new)[bad].max(), tol[bad].min())


def _group_cosine(grads, jg, group):
    keys = [k for k in grads if (k[0] == "feature_net") == (group == 0)]
    g = np.concatenate([grads[k].ravel() for k in keys])
    r = np.concatenate([jg[m][n].numpy().ravel() for m, n in keys])
    return float(np.dot(g, r) / (np.linalg.norm(g) * np.linalg.norm(r)))


@pytest.mark.parametrize("backbone", ["ibrnet", "gnt"])
def test_train_step_f32_matches_jax(backbone):
    """The same step in f32 at the attack step's gates: the loss to 1e-4 and
    each parameter group's gradient (feature net; aggregators) by direction.
    Gradients are compared rather than Adam's first update, which turns
    rounding noise at |g| ~ 1e-8 into steps of the full learning rate."""
    kw = {"depth_var_loss": 0.1} if backbone == "ibrnet" else {}
    jloss, jg, _, taux, grads, _ = _step_both(backbone, False, **kw)
    assert taux["loss"].dtype == torch.float32
    np.testing.assert_allclose(float(taux["loss"]), jloss, rtol=1e-4)
    for group in (0, 1):
        assert _group_cosine(grads, jg, group) > 0.99, group


def test_adv_inner_loop_float64_matches_jax():
    """Three sign-PGD iterations of adversarial training (IBRNet, a fine
    level, stochastic sampling) from JAX's delta0, ray indices and sampling
    draws: the final delta by direction and by the share of entries that
    differ, and the loop's constraints."""
    rng = np.random.RandomState(7)
    jb, tb, target, src, _ = _scene(rng, "ibrnet")
    jr, tr, kw = _train_cfgs("ibrnet", use_adv_train=True, adv_iters=3,
                             epsilon=8.0, adv_lr=2.0)
    jr = dataclasses.replace(jr, compute_dtype="float64")
    f64 = lambda d: {k: v.astype(np.float64) if v.dtype.kind == "f" else v
                     for k, v in d.items()}
    batch = _batch(f64(target), f64(src))
    jcfg = j_trainer.TrainConfig(**kw)
    eps = 8.0 / 255.0
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              jb.params)
        step, _ = j_trainer.make_train_step(
            dataclasses.replace(jb, params=params), jr, jcfg)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        k_sel, k_adv, _ = jax.random.split(jax.random.PRNGKey(5), 3)
        sel = np.asarray(j_trainer._select_rays(k_sel, jcfg))
        d_jax = np.asarray(step.adv_perturb_sources(params, jbatch,
                                                    jnp.asarray(sel), k_adv))
        # the draws adv_perturb_sources makes from k_adv
        k0, k_it = jax.random.split(k_adv)
        delta0 = np.asarray(jax.random.uniform(
            k0, batch["src_rgbs"].shape, jnp.float64, -eps, eps))
        inner = [_jax_render_draws(jax.random.fold_in(k_it, i), jr, len(sel),
                                   np.float64) for i in range(3)]
    for m in (tb.feature_net, tb.net_coarse, tb.net_fine):
        m.double()
    tstep, _, _ = t_trainer.make_train_step(tb, tr,
                                            t_trainer.TrainConfig(**kw))
    tbatch = {k: _t(v) for k, v in batch.items()}
    d_t = tstep.adv_perturb_sources(
        tbatch, _t(sel), {"delta0": _t(delta0), "inner": inner}).numpy()
    cos = float(np.sum(d_t * d_jax)
                / (np.linalg.norm(d_t) * np.linalg.norm(d_jax)))
    mismatch = float(np.mean(np.abs(d_t - d_jax) > 1e-9))
    assert cos > 0.9999, cos
    assert mismatch < 0.01, mismatch
    src_rgbs = batch["src_rgbs"]
    assert np.abs(d_t).max() <= eps + 1e-12
    assert (src_rgbs + d_t).min() >= -1e-12
    assert (src_rgbs + d_t).max() <= 1 + 1e-12
    assert np.abs(d_t - np.clip(delta0, -src_rgbs, 1 - src_rgbs)).max() > 0
    # the weights stay trainable after the frozen inner loop
    assert all(p.requires_grad for p in tstep.params)


# ---- the optimizer, the rays ----

def test_lr_schedule_and_adam_match_optax():
    """Five updates with decay every 2 steps: each group's rate equals
    optax's staircase schedule at that count (to f32 rounding: optax's
    schedule is f32), and the parameters after torch's Adam equal optax's
    on the same gradients (float64, where the two Adams' different rounding
    orders stay far below the rates' f32 rounding)."""
    cfg = t_trainer.TrainConfig(h=H, w=W, lrate_feature=1e-3, lrate_mlp=5e-4,
                                lrate_decay_factor=0.5, lrate_decay_steps=2)
    bundle = create_model(backbone="ibrnet", seed=0)
    for m in (bundle.feature_net, bundle.net_coarse, bundle.net_fine):
        m.double()
    opt, sched = t_trainer.make_optimizer(cfg, bundle)
    groups = [list(bundle.feature_net.parameters()),
              [p for m in (bundle.net_coarse, bundle.net_fine)
               for p in m.parameters()]]
    assert [g["params"] for g in opt.param_groups] == groups
    flat = groups[0] + groups[1]
    rng = np.random.RandomState(0)
    with jax.enable_x64(True):
        jparams = {"feature_net": [jnp.asarray(p.detach().numpy())
                                   for p in groups[0]],
                   "net_coarse": [jnp.asarray(p.detach().numpy())
                                  for p in groups[1]]}
        jopt = j_trainer.make_optimizer(
            j_trainer.TrainConfig(**dataclasses.asdict(cfg)), jparams)
        jstate = jopt.init(jparams)
        update = jax.jit(jopt.update)
        for t in range(5):
            for base, g in zip((1e-3, 5e-4), opt.param_groups):
                ref = float(optax.exponential_decay(base, 2, 0.5,
                                                    staircase=True)(t))
                np.testing.assert_allclose(g["lr"], ref, rtol=1e-7)
            grads = {k: [jnp.asarray(rng.randn(*p.shape)
                                     * 10.0 ** rng.randint(-5, 0))
                         for p in v] for k, v in jparams.items()}
            upd, jstate = update(grads, jstate, jparams)
            jparams = optax.apply_updates(jparams, upd)
            for p, g in zip(flat, grads["feature_net"] + grads["net_coarse"]):
                p.grad = _t(g)
            opt.step()
            sched.step()
        ref = [np.asarray(r) for r in jparams["feature_net"]
               + jparams["net_coarse"]]
    # optax's rates are f32 even under x64: each of the five updates (at
    # most lr, 1e-3) may differ by the rate's f32 rounding (2^-24 of it)
    for p, r in zip(flat, ref):
        assert p.dtype == torch.float64 and r.dtype == np.float64
        np.testing.assert_allclose(p.detach().numpy(), r, rtol=0,
                                   atol=5 * 1e-3 * 2.0 ** -23)
    moved = max(float(np.abs(p.detach().numpy() - q.detach().numpy()).max())
                for p, q in zip(flat, create_model(backbone="ibrnet", seed=0)
                                .feature_net.parameters()))
    assert moved > 1e-4
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.25)


@pytest.mark.parametrize("mode", ["uniform", "center"])
def test_select_rays(mode):
    cfg = t_trainer.TrainConfig(h=30, w=40, n_rand=300, sample_mode=mode,
                                center_ratio=0.8)
    sel = t_trainer.select_rays(torch.Generator().manual_seed(1), cfg)
    assert sel.dtype == torch.int64 and sel.shape == (300,)
    assert len(set(sel.tolist())) == 300
    assert int(sel.min()) >= 0 and int(sel.max()) < 30 * 40
    rows, cols = sel // 40, sel % 40
    if mode == "center":
        bh, bw = int(30 * (1 - 0.8) / 2.0), int(40 * (1 - 0.8) / 2.0)
        assert int(rows.min()) >= bh and int(rows.max()) < 30 - bh
        assert int(cols.min()) >= bw and int(cols.max()) < 40 - bw
    else:
        assert int(rows.max()) - int(rows.min()) > 20


# ---- the Trainer: mirrors of tests/test_trainer.py ----

def _trainer(tmp_path, **cfg_kw):
    ds = SyntheticDataset(mode="train", n_views=8, h=H, w=W)
    bundle = create_model(backbone="ibrnet", seed=0)
    render_cfg = RenderConfig(n_samples=12, n_importance=0, det=True,
                              backbone="ibrnet")
    cfg = t_trainer.TrainConfig(h=H, w=W, n_rand=64, **cfg_kw)
    tr = t_trainer.Trainer(bundle, render_cfg, cfg,
                           out_dir=str(tmp_path / "out"))
    return tr, itertools.repeat(ds[0])


def test_training_reduces_loss(tmp_path):
    tr, it = _trainer(tmp_path)
    lines = []
    tr.train(it, 12, generator=torch.Generator().manual_seed(1), i_print=4,
             log_fn=lines.append)
    vals = [float(re.search(r"loss=([\d.]+)", s).group(1)) for s in lines]
    assert len(vals) == 3 and vals[-1] < vals[0], vals
    assert [h["step"] for h in tr.history] == [4, 8, 12]


def test_adv_training_runs(tmp_path):
    tr, it = _trainer(tmp_path, use_adv_train=True, adv_iters=2)
    tr.train(it, 2, generator=torch.Generator().manual_seed(1), i_print=1,
             log_fn=lambda s: None)
    delta, src = tr.last_aux["delta"], tr.last_batch["src_rgbs"]
    assert float(delta.abs().max()) <= 8.0 / 255.0 + 1e-7
    assert float((src + delta).min()) >= -1e-7
    assert float((src + delta).max()) <= 1 + 1e-7
    assert np.isfinite([h["loss"] for h in tr.history]).all()


def test_checkpoint_roundtrip(tmp_path):
    """A saved step resumes with its weights, optimizer and schedule, and
    the evaluators' ``create_model`` loads the same checkpoint."""
    tr, it = _trainer(tmp_path)
    tr.train(it, 3, generator=torch.Generator().manual_seed(1), i_print=10,
             log_fn=lambda s: None)
    path = tr.save(3)
    assert os.path.basename(path) == "model_000003.pth"
    tr2, _ = _trainer(tmp_path)
    assert tr2.load_latest() == 3
    loaded = create_model(backbone="ibrnet", ckpt_path=path)
    for name in ("feature_net", "net_coarse", "net_fine"):
        want = getattr(tr.bundle, name).state_dict()
        for other in (tr2.bundle, loaded):
            got = getattr(other, name).state_dict()
            assert set(got) == set(want)
            for k in want:
                torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    s1, s2 = tr.optimizer.state_dict(), tr2.optimizer.state_dict()
    assert float(s2["state"][0]["step"]) == float(s1["state"][0]["step"]) == 3
    torch.testing.assert_close(s2["state"][0]["exp_avg"],
                               s1["state"][0]["exp_avg"], rtol=0, atol=0)
    assert tr2.scheduler.last_epoch == 3
    blob = torch.load(path, weights_only=True)
    assert set(blob) == {"feature_net", "net_coarse", "net_fine",
                         "optimizer", "scheduler", "step"}


def test_i_img_panels_match_jax_file_names(tmp_path):
    """``i_img`` renders a view and writes the panels JAX's ``log_view``
    writes, under the same file names."""
    tr, it = _trainer(tmp_path)
    tr.train(it, 2, generator=torch.Generator().manual_seed(1), i_print=1,
             log_fn=lambda s: None, i_img=2, val_iter=it,
             logger=ScalarLogger(str(tmp_path / "port"), "t"))
    jtr = j_trainer.Trainer(
        j_create_model(backbone="ibrnet", rng_key=jax.random.PRNGKey(0)),
        JRenderConfig(n_samples=12, det=True, backbone="ibrnet"),
        j_trainer.TrainConfig(h=H, w=W, n_rand=64),
        out_dir=str(tmp_path / "jout"))
    jtr.log_view(JSyntheticDataset(mode="train", n_views=8, h=H, w=W)[0], 2,
                 JScalarLogger(str(tmp_path / "jax"), "t"))
    names = [sorted(os.listdir(tmp_path / d / "images"))
             for d in ("port", "jax")]
    assert names[0] == names[1], names
    assert {"val_gt_rgb_00000002.png", "val_pred_coarse_00000002.png",
            "val_depth_coarse_00000002.png"} <= set(names[0])


def test_scalar_logger_records_match_jax(tmp_path):
    logs, paths = [], []
    for cls, d in ((ScalarLogger, "port"), (JScalarLogger, "jax")):
        lg = cls(str(tmp_path / d), "train")
        lg.add_scalar("train/loss", np.float32(0.25), 3)
        lg.add_scalars({"train/psnr": 6.0, "train/lr": 1e-3}, 4)
        lg.close()
        paths.append(os.path.relpath(lg.path, tmp_path / d))
        with open(lg.path) as f:
            logs.append([json.loads(line) for line in f])
    port, ref = logs
    assert paths[0] == paths[1] == "train_scalars.jsonl"
    assert len(port) == 3 and [set(r) for r in port] == [set(r) for r in ref]
    strip = lambda rows: [{k: v for k, v in r.items() if k != "wall"}
                          for r in rows]
    assert strip(port) == strip(ref)


def test_train_cli_writes_run_files(tmp_path):
    """``python -m nerfool_tpu_torch.train --device cpu`` on the synthetic
    scene: the flags, the code snapshot, the scalars and a checkpoint that
    ``create_model`` loads; with ``--distributed`` a world of one rank
    (gloo on the CPU) trains to the same checkpoint."""
    argv = [sys.executable, "-m", "nerfool_tpu_torch.train", "--device",
            "cpu", "--train_dataset", "synthetic", "--ckpt_path", "",
            "--n_iters", "3", "--i_print", "1", "--N_samples", "8",
            "--num_source_views", "3", "--N_rand", "32", "--workers", "0",
            "--out_dir", str(tmp_path), "--expname", "run",
            "--dataset_kwargs", json.dumps({"n_views": 6, "h": H, "w": W})]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run(argv, capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert len(re.findall(r"^step \d: loss=", res.stdout, re.M)) == 3
    run = tmp_path / "run"
    files = set(os.listdir(run))
    assert {"args.txt", "code_snapshot.zip", "train_scalars.jsonl",
            "model_000003.pth"} <= files, files
    import zipfile

    names = zipfile.ZipFile(run / "code_snapshot.zip").namelist()
    assert "nerfool_tpu_torch/train/trainer.py" in names
    assert "configs/ibrnet/pretrain.txt" in names
    assert not any(n.startswith("nerfool_tpu/") for n in names)
    assert "n_iters = 3" in (run / "args.txt").read_text()
    create_model(backbone="ibrnet", ckpt_path=str(run / "model_000003.pth"))
    argv[argv.index("run")] = "run_dist"
    res = subprocess.run(argv + ["--distributed"], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "process 0/1" in res.stdout
    one, dist = (torch.load(tmp_path / d / "model_000003.pth",
                            weights_only=True) for d in ("run", "run_dist"))
    for net in ("feature_net", "net_coarse", "net_fine"):
        for k, v in one[net].items():
            assert torch.equal(v, dist[net][k]), (net, k)
