"""The port's attack step (``nerfool_tpu_torch/attack``) against the JAX
package on the CPU: perturbation helpers, every loss term, ray selection, the
Adam and sign-PGD updates, and one whole attack step per backbone. The
camera-pose attack, gradient surgery and the universal loop are in
tests/test_torch_universal.py.

Inputs come from numpy seeds and go through both packages; weights are the
JAX bundle's, carried over by ``convert.params_from_flax``. JAX keys and
torch generators never agree bit for bit, so the step is given the ray
indices JAX would draw (``select_ray_indices(jax.random.split(key, 3)[0])``)
and the same initial ``delta``.

Tolerances: elementwise helpers and losses 1e-6 (f32 on both sides, the
same formulas); Adam against optax 1e-7 on equal gradient arrays; the step's
loss and every loss term 1e-4 relative (summation order through the feature
net and the renderer); its gradient by direction, cosine > 0.99 and sign
agreement > 0.9, because the deep InstanceNorm backward amplifies f32
rounding (the protocol of tests/test_attack.py's reference-parity check).
The gradient is read from Adam's first moment after one step, m = -0.1 g.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from helpers import synthetic_scene

from nerfool_tpu.attack import attack as j_attack
from nerfool_tpu.attack import losses as j_losses
from nerfool_tpu.attack import perturb as j_perturb
from nerfool_tpu.models.bundle import create_model as j_create_model
from nerfool_tpu.render.render_rays import RenderConfig as JRenderConfig
from nerfool_tpu.utils.cameras import get_rays as j_get_rays

from nerfool_tpu_torch.attack import attack as t_attack
from nerfool_tpu_torch.attack import losses as t_losses
from nerfool_tpu_torch.attack import perturb as t_perturb
from nerfool_tpu_torch.engine import build_attack_config
from nerfool_tpu_torch.models.bundle import create_model
from nerfool_tpu_torch.models.convert import params_from_flax
from nerfool_tpu_torch.render.render_rays import RenderConfig
from nerfool_tpu_torch.utils.cameras import get_rays_at

# the test tier runs several worker processes on a few cores: two math
# threads per process instead of one per core keeps them from thrashing
torch.set_num_threads(2)

H, W = 24, 32


def _t(x):
    return torch.as_tensor(np.array(x))


# ---- perturb ----

def test_perturb_matches_jax():
    rng = np.random.RandomState(0)
    src = rng.rand(3, 6, 7, 3).astype(np.float32)
    delta = ((rng.rand(3, 6, 7, 3) * 2 - 1) * 0.1).astype(np.float32)
    eps = 8.0 / 255.0
    np.testing.assert_allclose(
        t_perturb.project_delta(_t(delta), _t(src), eps).numpy(),
        np.asarray(j_perturb.project_delta(jnp.asarray(delta),
                                           jnp.asarray(src), eps)), atol=1e-6)
    np.testing.assert_allclose(
        t_perturb.clamp(_t(delta), -0.01, _t(src) * 0.05).numpy(),
        np.asarray(j_perturb.clamp(jnp.asarray(delta), -0.01,
                                   jnp.asarray(src) * 0.05)), atol=1e-6)
    # init_delta: the uniform draw of a generator, clamped as JAX clamps it
    d0 = t_perturb.init_delta(torch.Generator().manual_seed(3), _t(src), eps)
    u = torch.rand(src.shape, generator=torch.Generator().manual_seed(3))
    ref = j_perturb.clamp(jnp.asarray(((2 * u - 1) * eps).numpy()),
                          0.0 - jnp.asarray(src), 1.0 - jnp.asarray(src))
    np.testing.assert_allclose(d0.numpy(), np.asarray(ref), atol=1e-6)
    assert float(d0.abs().max()) <= eps
    assert float((_t(src) + d0).min()) >= 0 and float(
        (_t(src) + d0).max()) <= 1
    assert float(d0.std()) > 0.3 * eps  # fills the ball, not a constant


# ---- losses ----

def _loss_cases():
    rng = np.random.RandomState(1)
    n, s = 12, 9
    f = lambda *shape: rng.rand(*shape).astype(np.float32)
    w = f(n, s)
    w[2] = 0.0  # a ray with a zero weight sum is dropped by depth_var
    out = {"rgb": f(n, 3), "mask": rng.rand(n) > 0.3, "alpha": f(n, s),
           "weights": w, "z_vals": np.sort(f(n, s) * 4 + 2, axis=1),
           "depth": f(n) * 4 + 2}
    out_gt = {"alpha": f(n, s)}
    no_mask = {"rgb": out["rgb"]}
    gt_rgb = f(n, 3)
    gt_depth = (f(n) * 4 + 2) * (rng.rand(n) > 0.25)  # zeros are masked out
    big = f(n) * 6  # |diff| crosses the smooth-L1 knee at 1
    return {
        "masked_mse_plain": ("masked_mse", (out["rgb"], gt_rgb)),
        "masked_mse_mask": ("masked_mse", (out["rgb"], gt_rgb,
                                           out["mask"].astype(np.float32))),
        "rgb_criterion_mask": ("rgb_criterion", (out, gt_rgb)),
        "rgb_criterion_plain": ("rgb_criterion", (no_mask, gt_rgb)),
        "smooth_l1": ("smooth_l1", (big, out["depth"], rng.rand(n) > 0.5)),
        "smooth_l1_empty_mask": ("smooth_l1", (big, out["depth"],
                                               np.zeros(n, bool))),
        "depth_diff_loss": ("depth_diff_loss", (out, gt_depth)),
        "depth_var_loss": ("depth_var_loss", (out,)),
        "depth_smooth_l2": ("depth_smooth_loss", (f(2 * 16), 4, "l2")),
        "depth_smooth_l1": ("depth_smooth_loss", (f(2 * 16), 4, "l1")),
        "density_loss": ("density_loss", (out, out_gt)),
    }


def _convert(x, fn):
    if isinstance(x, dict):
        return {k: fn(v) for k, v in x.items()}
    return fn(x) if isinstance(x, np.ndarray) else x


@pytest.mark.parametrize("case", sorted(_loss_cases()))
def test_loss_matches_jax(case):
    name, args = _loss_cases()[case]
    got = getattr(t_losses, name)(*(_convert(a, _t) for a in args))
    ref = getattr(j_losses, name)(*(_convert(a, jnp.asarray) for a in args))
    np.testing.assert_allclose(float(got), float(ref), atol=1e-6, rtol=1e-6)


# ---- ray selection ----

def test_select_uniform_and_center():
    gen = torch.Generator().manual_seed(0)
    cfg = t_attack.AttackConfig(h=24, w=32, n_rand=64)
    sel = t_attack.select_ray_indices(gen, cfg).numpy()
    assert sel.shape == (64,) and len(np.unique(sel)) == 64
    assert sel.min() >= 0 and sel.max() < 24 * 32
    assert not np.array_equal(
        sel, t_attack.select_ray_indices(gen, cfg).numpy())  # a new draw
    cfg_c = dataclasses.replace(cfg, n_rand=32, sample_mode="center",
                                center_ratio=0.5)
    sel = t_attack.select_ray_indices(gen, cfg_c).numpy()
    assert sel.shape == (32,) and len(np.unique(sel)) == 32
    rows, cols = sel // 32, sel % 32
    assert rows.min() >= 6 and rows.max() < 18
    assert cols.min() >= 8 and cols.max() < 24


def test_select_patch_layout_matches_jax():
    """Same anchors, same pixel order as JAX (row offset fastest)."""
    key = jax.random.PRNGKey(0)
    jcfg = j_attack.AttackConfig(h=24, w=32, n_rand=64,
                                 use_patch_sampling=True, patch_size=4)
    ref = np.asarray(j_attack.select_ray_indices(key, jcfg))
    kx, ky = jax.random.split(key)
    x0 = np.asarray(jax.random.randint(kx, (4, 1), 0, 24 - 4 + 1))
    y0 = np.asarray(jax.random.randint(ky, (4, 1), 0, 32 - 4 + 1))
    got = t_attack.patch_indices(_t(x0).long(), _t(y0).long(), 4, 32).numpy()
    np.testing.assert_array_equal(got, ref)
    # the port's own draw: n_rand // p^2 patches inside the frame
    cfg = t_attack.AttackConfig(h=24, w=32, n_rand=64,
                                use_patch_sampling=True, patch_size=4)
    sel = t_attack.select_ray_indices(torch.Generator().manual_seed(1),
                                      cfg).numpy().reshape(4, 16)
    rows, cols = sel // 32, sel % 32
    for r_, c_ in zip(rows, cols):
        assert np.array_equal(r_ - r_[0], np.tile(np.arange(4), 4))
        assert np.array_equal(c_ - c_[0], np.repeat(np.arange(4), 4))
    assert rows.max() < 24 and cols.max() < 32


def test_get_rays_at_matches_jax_full_rays():
    from helpers import orbit_cameras

    cam = orbit_cameras(2, H, W)[1]
    intr, c2w = cam[2:18].reshape(4, 4), cam[18:34].reshape(4, 4)
    sel = np.random.RandomState(0).choice(H * W, 30, replace=False)
    ro, rd = get_rays_at(_t(sel), W, _t(intr), _t(c2w))
    jo, jd = j_get_rays(H, W, jnp.asarray(intr), jnp.asarray(c2w))
    np.testing.assert_allclose(rd.numpy(), np.asarray(jd)[sel], atol=1e-6)
    np.testing.assert_allclose(ro.numpy(), np.asarray(jo)[sel], atol=1e-6)


# ---- optimizers ----

def test_adam_update_matches_optax():
    """5 steps on equal gradient arrays, staircase decay every 2 steps."""
    rng = np.random.RandomState(2)
    jcfg = j_attack.AttackConfig(h=H, w=W, use_adam=True, adam_lr=1e-3,
                                 lr_step_size=2, lr_gamma=0.5)
    cfg = t_attack.AttackConfig(h=H, w=W, use_adam=True, adam_lr=1e-3,
                                lr_step_size=2, lr_gamma=0.5)
    p0 = ((rng.rand(2, 5, 6, 3) * 2 - 1) * 0.03).astype(np.float32)
    opt = j_attack.make_optimizer(jcfg)
    jp, jstate = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = _t(p0)
    m, v = torch.zeros_like(tp), torch.zeros_like(tp)
    for step in range(5):
        g = (rng.randn(*p0.shape) * 10.0 ** rng.randint(-6, 0)).astype(
            np.float32)
        upd, jstate = opt.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tp, m, v = t_attack.adam_update(tp, _t(g), m, v, step,
                                        t_attack.adam_lr(cfg, step))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-7,
                                   rtol=0)
    assert t_attack.adam_lr(cfg, 4) == pytest.approx(1e-3 * 0.25)


# ---- one attack step ----

def _scene(rng, backbone):
    target_cam, src_rgbs, src_cams, _, depth_range = synthetic_scene(
        rng, n_src=3, h=H, w=W)
    if backbone == "ibrnet":
        jb = j_create_model(backbone="ibrnet", rng_key=jax.random.PRNGKey(11))
    else:
        jb = j_create_model(backbone="gnt", rng_key=jax.random.PRNGKey(5),
                            trans_depth=2, single_net=True)
    tb = create_model(backbone=backbone, trans_depth=2, single_net=True,
                      state_dicts=params_from_flax(
                          jax.tree.map(np.asarray, jb.params)))
    target = {"camera": target_cam,
              "rgb": rng.rand(H * W, 3).astype(np.float32),
              "depth": (rng.rand(H * W) * 4 + 2).astype(np.float32),
              "depth_range": depth_range}
    src = {"rgbs": src_rgbs, "cameras": src_cams}
    eps = 8.0 / 255.0
    delta0 = ((rng.rand(*src_rgbs.shape) * 2 - 1) * eps).astype(np.float32)
    delta0 = np.clip(delta0, -src_rgbs, 1 - src_rgbs)
    return jb, tb, target, src, delta0


def _render_cfgs(backbone, n_importance=0):
    if backbone == "ibrnet":
        return (JRenderConfig(n_samples=12, n_importance=n_importance,
                              det=True, backbone="ibrnet"),
                RenderConfig(n_samples=12, n_importance=n_importance,
                             backbone="ibrnet"))
    return (JRenderConfig(n_samples=10, det=True, backbone="gnt",
                          single_net=True, ret_alpha=True,
                          stop_camera_grad=False),
            RenderConfig(n_samples=10, backbone="gnt", single_net=True,
                         ret_alpha=True))


def _run_both(backbone, n_importance=0, **cfg_kw):
    """One step of each package from the same delta0 and ray indices."""
    rng = np.random.RandomState(7)
    jb, tb, target, src, delta0 = _scene(rng, backbone)
    jr, tr = _render_cfgs(backbone, n_importance)
    cfg_kw = dict(h=H, w=W, n_rand=32, **cfg_kw)
    jcfg = j_attack.AttackConfig(**cfg_kw)
    tcfg = t_attack.AttackConfig(**cfg_kw)

    key = jax.random.PRNGKey(2)
    k_sel, k_render, _ = jax.random.split(key, 3)
    sel = np.asarray(j_attack.select_ray_indices(k_sel, jcfg))
    sel_patch = np.asarray(j_attack.select_ray_indices(
        jax.random.fold_in(k_render, 23),
        dataclasses.replace(jcfg, use_patch_sampling=True)))

    jsrc = {k: jnp.asarray(v) for k, v in src.items()}
    jsrc["featmaps_clean"] = jb.extract_features(jsrc["rgbs"])
    jtarget = {k: jnp.asarray(v) for k, v in target.items()}
    jstate = j_attack.init_attack_state(jax.random.PRNGKey(1), jcfg,
                                        jsrc["rgbs"])
    jstate = dict(jstate, delta=jnp.asarray(delta0))
    jstate, jaux = jax.jit(j_attack.make_attack_step(jb, jr, jcfg))(
        jstate, jtarget, jsrc, key)

    tsrc = {k: _t(v) for k, v in src.items()}
    with torch.no_grad():
        tsrc["featmaps_clean"] = tb.extract_features(tsrc["rgbs"])
    ttarget = {k: _t(v) for k, v in target.items()}
    tstate = t_attack.init_attack_state(None, tcfg, tsrc["rgbs"],
                                        delta=_t(delta0))
    tstate, taux = t_attack.make_attack_step(tb, tr, tcfg)(
        tstate, ttarget, tsrc, sel=_t(sel), sel_patch=_t(sel_patch))
    return jstate, jaux, tstate, taux, tsrc


def _check_direction(g, r):
    g, r = np.asarray(g).ravel(), np.asarray(r).ravel()
    cosine = np.dot(g, r) / (np.linalg.norm(g) * np.linalg.norm(r) + 1e-30)
    assert cosine > 0.99, cosine
    assert np.mean(np.sign(g) == np.sign(r)) > 0.9


@pytest.mark.parametrize("backbone", ["ibrnet", "gnt"])
def test_adam_attack_step_matches_jax(backbone):
    jstate, jaux, tstate, taux, tsrc = _run_both(
        backbone, use_adam=True, adam_lr=1e-3)
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-4)
    # Adam's first moment after one step is -0.1 * gradient
    _check_direction(tstate["m"].numpy(), jstate["opt_state"][0].mu[0])
    assert tstate["step"] == int(jstate["step"]) == 1
    delta = tstate["delta"]
    assert float(delta.abs().max()) <= 8.0 / 255.0 + 1e-7
    assert float((tsrc["rgbs"] + delta).min()) >= -1e-7
    assert float((tsrc["rgbs"] + delta).max()) <= 1 + 1e-7
    # the first Adam step moves every entry by ~lr: where the two gradients
    # agree in sign the updates agree
    same = np.sign(tstate["m"].numpy()) == np.sign(
        np.asarray(jstate["opt_state"][0].mu[0]))
    np.testing.assert_allclose(delta.numpy()[same],
                               np.asarray(jstate["delta"])[same], atol=2e-5)


# the float64 holds: (backbone, attack flags, how the target is chosen).
# universal: a streamed target camera between the sources with the pseudo
# ground truth of the clean features; pcgrad: gradient surgery over rgb and
# depth variance; unseen: an interpolated unseen pose as the target
# (pseudo ground truth, which --use_unseen_views forces), a fine level, the
# density and depth-difference terms; pose: the camera-pose attack on GNT
# from a non-zero rot / trans
F64_CASES = {
    "ibrnet": ("ibrnet", {}, None),
    "gnt": ("gnt", {}, None),
    "universal": ("ibrnet", {"use_pseudo_gt": True}, "between"),
    "pcgrad": ("ibrnet", {"use_pcgrad": True, "depth_var_loss": 0.1}, None),
    "unseen": ("ibrnet", {"use_pseudo_gt": True, "density_loss": 0.5,
                          "depth_diff_loss": 0.3}, "unseen"),
    "pose": ("gnt", {"perturb_camera": True, "rot_epsilon": 5.0,
                     "trans_epsilon": 0.05}, None),
}


@pytest.mark.parametrize("case", list(F64_CASES))
def test_attack_step_float64_matches_jax(case):
    """One Adam step of the attack in float64 on the module path, per
    backbone (view-specific) and per mode (``F64_CASES``), against JAX under
    x64 from the same delta0 (rot0, trans0) and ray indices (drawn under
    x64, whose bits differ): the loss at PARITY.md's TRAJECTORY bound
    (step-1 loss 1e-7), the gradients (Adam's first moments; the camera
    parameters' too under the pose attack) 1e-7 of their scale. Where the
    float32 step is held at 1e-4 (the feature net's float32 rounding,
    ROADMAP §3), float64 takes that rounding out. GNT computes its
    positional encodings of float64 points in float32 in both packages, as
    tests/test_torch_defenses.py's GNT renders do."""
    from helpers import orbit_cameras
    from nerfool_tpu_torch.attack.geo_interp import sample_unseen_pose

    backbone, flags, target_kind = F64_CASES[case]
    rng = np.random.RandomState(7)
    jb, tb, target, src, delta0 = _scene(rng, backbone)
    jr, tr = _render_cfgs(backbone, 8 if case == "unseen" else 0)
    jr = dataclasses.replace(jr, compute_dtype="float64")
    if case == "pose":  # the camera gradient flows through the projection
        tr = dataclasses.replace(tr, stop_camera_grad=False)
    cfg_kw = dict(h=H, w=W, n_rand=32, use_adam=True, adam_lr=1e-3, **flags)
    jcfg = j_attack.AttackConfig(**cfg_kw)
    tcfg = t_attack.AttackConfig(**cfg_kw)
    if target_kind == "between":
        target["camera"] = orbit_cameras(8, H, W)[3]
    elif target_kind == "unseen":
        pose = sample_unseen_pose(np.random.RandomState(5),
                                  src["cameras"][:, 18:34].reshape(-1, 4, 4))
        target["camera"] = target["camera"].copy()
        target["camera"][18:34] = pose.reshape(-1)
    cams0 = {}
    if case == "pose":
        r = np.random.RandomState(3)
        cams0 = {"rot": (r.rand(3, 3) * 2 - 1) * np.deg2rad(5.0) * 0.5,
                 "trans": (r.rand(3, 3) * 2 - 1) * 0.05 * 0.5}
    f64 = lambda d: {k: v.astype(np.float64) if v.dtype.kind == "f" else v
                     for k, v in d.items()}
    target, src, delta0 = f64(target), f64(src), delta0.astype(np.float64)
    key = jax.random.PRNGKey(2)
    with jax.enable_x64(True):
        k_sel, k_render, k_pc = jax.random.split(key, 3)
        sel = np.asarray(j_attack.select_ray_indices(k_sel, jcfg))
        sel_patch = np.asarray(j_attack.select_ray_indices(
            jax.random.fold_in(k_render, 23),
            dataclasses.replace(jcfg, use_patch_sampling=True)))
        order = np.asarray(jax.random.permutation(
            k_pc, len(jcfg.enabled_losses())))
        jb = dataclasses.replace(jb, params=jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64), jb.params))
        jsrc = {k: jnp.asarray(v) for k, v in src.items()}
        jsrc["featmaps_clean"] = jb.extract_features(jsrc["rgbs"])
        jstate = dict(j_attack.init_attack_state(
            jax.random.PRNGKey(1), jcfg, jsrc["rgbs"]),
            delta=jnp.asarray(delta0),
            **{k: jnp.asarray(v) for k, v in cams0.items()})
        jstate, jaux = jax.jit(j_attack.make_attack_step(jb, jr, jcfg))(
            jstate, {k: jnp.asarray(v) for k, v in target.items()}, jsrc, key)
        jm = [np.asarray(m) for m in jstate["opt_state"][0].mu]
        jloss = float(jaux["loss"])
    for m in (tb.feature_net, tb.net_coarse, tb.net_fine):
        if m is not None:
            m.double()
    tsrc = {k: _t(v) for k, v in src.items()}
    with torch.no_grad():
        tsrc["featmaps_clean"] = tb.extract_features(tsrc["rgbs"])
    tstate = t_attack.init_attack_state(
        None, tcfg, tsrc["rgbs"], delta=_t(delta0),
        **{k: _t(v) for k, v in cams0.items()})
    tstate, taux = t_attack.make_attack_step(tb, tr, tcfg)(
        tstate, {k: _t(v) for k, v in target.items()}, tsrc, sel=_t(sel),
        sel_patch=_t(sel_patch), pc_order=order)
    assert tstate["m"].dtype == torch.float64
    assert set(taux) == set(jaux)
    np.testing.assert_allclose(float(taux["loss"]), jloss, rtol=1e-7)
    names = ("m", "m_rot", "m_trans") if case == "pose" else ("m",)
    for name, ref in zip(names, jm):
        got = tstate[name].numpy()
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(got, ref, rtol=0, err_msg=name,
                                   atol=1e-7 * np.abs(ref).max())


def test_pgd_attack_step_matches_jax():
    """Sign-PGD: delta moves by adv_lr / 255 along the gradient's sign."""
    jstate, jaux, tstate, taux, _ = _run_both("ibrnet", adv_lr=2.0)
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-4)
    agree = np.isclose(tstate["delta"].numpy(), np.asarray(jstate["delta"]),
                       atol=1e-7)
    assert agree.mean() > 0.9


def test_every_loss_term_matches_jax():
    """Pseudo ground truth, density, depth variance, depth difference and
    depth smoothness (with its dedicated patch batch), coarse and fine."""
    jstate, jaux, tstate, taux, _ = _run_both(
        "ibrnet", n_importance=8, use_adam=True, adam_lr=1e-3,
        use_pseudo_gt=True, density_loss=0.5, depth_var_loss=0.1,
        depth_diff_loss=0.3, depth_smooth_loss=0.2, patch_size=4)
    assert set(taux) == {"loss", "rgb", "density", "depth_var", "depth_diff",
                         "depth_smooth"}
    for name in taux:
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    _check_direction(tstate["m"].numpy(), jstate["opt_state"][0].mu[0])


# ---- the consistency options run ----

def _ran(ev):
    """What an evaluator's last run did: the attack's loss terms, the
    defenses, the hybrid render modes and the sigma noise."""
    cfg = ev.render_cfg
    ran = set(ev.last_attack["terms"]) if ev.last_attack else set()
    ran |= set(ev.last_defenses)
    ran |= {n for n in ("use_clean_color", "use_clean_density")
            if getattr(cfg, n)}
    return ran | ({"geo_noise"} if cfg.geo_noise > 0 else set())


def _run_tiny(tmp_path, argv, dataset_kwargs):
    """``eval_adv``'s evaluator on one view: (evaluator, the view's row)."""
    from nerfool_tpu_torch import eval_adv
    from nerfool_tpu_torch.engine import Evaluator

    args = eval_adv.parse_args([*argv, "--max_views", "1"])
    ev = Evaluator(args, dataset_kwargs=dataset_kwargs, device="cpu", seed=0)
    res = ev.evaluate(max_views=1, verbose=False)["synthetic"]
    row = next(v for v in res.values() if isinstance(v, dict))
    assert np.isfinite([row["coarse_psnr"], row["coarse_ssim"]]).all()
    return ev, row


@pytest.mark.parametrize("flag,value,ran", [
    ("depth_consistency_loss", 0.5, {"rgb", "depth_cons"}),
    ("camera_consistency_loss", 0.5, {"rgb", "camera_cons"}),
    ("ds_rgb", True, {"rgb"})])
def test_consistency_options_run(tmp_path, monkeypatch, flag, value, ran):
    """A tiny view-specific ``eval_adv`` run with each option (1 iteration,
    32 rays, 24x32 frames) gives finite rows and reports the terms it ran;
    ``--ds_rgb`` alone changes nothing, as in JAX."""
    monkeypatch.chdir(tmp_path)
    argv = ["--eval_dataset", "synthetic", "--N_samples", "12",
            "--num_source_views", "4", "--rootdir", str(tmp_path),
            "--workers", "0", "--device", "cpu", "--N_rand", "32",
            "--adv_iters", "1", "--view_specific", "--use_adam",
            f"--{flag}", *(() if value is True else (str(value),))]
    ev, _ = _run_tiny(tmp_path, argv, {"n_views": 8, "h": H, "w": W})
    assert getattr(build_attack_config(ev.args, H, W), flag) == value
    assert _ran(ev) == ran


@pytest.mark.parametrize("flag", ["use_pcgrad", "perturb_camera",
                                  "perturb_camera_no_opt"])
def test_ported_attack_options_build_a_step(flag):
    """Gradient surgery and the camera-pose attack build a step."""
    tb = create_model(backbone="ibrnet", seed=0)
    cfg = t_attack.AttackConfig(h=H, w=W, **{flag: True})
    assert callable(t_attack.make_attack_step(tb, RenderConfig(n_samples=8),
                                              cfg))


def test_density_loss_needs_pseudo_gt():
    tb = create_model(backbone="ibrnet", seed=0)
    cfg = t_attack.AttackConfig(h=H, w=W, density_loss=0.5)
    with pytest.raises(ValueError, match="use_pseudo_gt"):
        t_attack.make_attack_step(tb, RenderConfig(n_samples=8), cfg)


def test_step_leaves_parameter_flags_as_found():
    """The nets are frozen only while a step runs: a trainer sharing the
    bundle finds ``requires_grad`` as it left it, and no ``.grad``."""
    rng = np.random.RandomState(3)
    target_cam, src_rgbs, src_cams, _, depth_range = synthetic_scene(
        rng, n_src=3, h=H, w=W)
    tb = create_model(backbone="ibrnet", seed=0)
    params = [p for m in (tb.feature_net, tb.net_coarse, tb.net_fine)
              if m is not None for p in m.parameters()]
    params[0].requires_grad_(False)
    before = [p.requires_grad for p in params]
    assert any(before) and not all(before)
    cfg = t_attack.AttackConfig(h=H, w=W, n_rand=16, use_adam=True)
    target = {"camera": _t(target_cam), "rgb": _t(rng.rand(H * W, 3)
                                                  .astype(np.float32)),
              "depth": None, "depth_range": _t(depth_range)}
    src = {"rgbs": _t(src_rgbs), "cameras": _t(src_cams),
           "featmaps_clean": None}
    state = t_attack.init_attack_state(torch.Generator().manual_seed(0), cfg,
                                       src["rgbs"])
    state, aux = t_attack.make_attack_step(
        tb, RenderConfig(n_samples=12, backbone="ibrnet"), cfg)(
        state, target, src, generator=torch.Generator().manual_seed(1))
    assert np.isfinite(float(aux["loss"]))
    assert [p.requires_grad for p in params] == before
    assert all(p.grad is None for p in params)
