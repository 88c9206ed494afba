"""The universal (view-generalizable) attack of the port against the JAX
package on the CPU: gradient surgery, the camera-pose transform and attack,
unseen-pose interpolation, the attack step in its new modes, the universal
loop with its checkpoint, and the evaluator's global-source rows.

Inputs come from numpy seeds and go through both packages; weights are the
JAX bundle's, carried over by ``convert.params_from_flax``. JAX keys and
torch generators never agree bit for bit, so each step is given the ray
indices JAX would draw and the same initial ``delta``, ``rot`` and ``trans``.

Tolerances: PCGrad, the camera transform and the pose interpolation 1e-6
(the same formulas, f32 or numpy f64); a step's loss 1e-4 relative, its
gradient on ``delta`` by direction (cosine > 0.99, sign agreement > 0.9: the
deep InstanceNorm backward amplifies f32 rounding, as in
tests/test_torch_attack.py), the camera parameters' updates 1e-5; the clean
global-source rows PSNR 1e-3 dB and SSIM 1e-4 (tests/test_torch_eval.py's
bounds). Attacked metrics are not compared between the packages:
trajectories diverge after a few iterations.
"""
import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers import orbit_cameras
from tests.test_engine import _engine_args
from tests.test_torch_attack import (H, W, _check_direction, _ran,
                                     _render_cfgs, _run_tiny, _scene, _t)

from nerfool_tpu.attack import attack as j_attack
from nerfool_tpu.attack import geo_interp as j_geo
from nerfool_tpu.attack.engine import AdvEvaluator
from nerfool_tpu.attack.pcgrad import pcgrad_combine as j_pcgrad
from nerfool_tpu.models.bundle import create_model as j_create_model
from nerfool_tpu.utils.cameras import transform_src_cameras as j_transform

from nerfool_tpu_torch import eval as port_eval
from nerfool_tpu_torch import eval_adv as port_eval_adv
from nerfool_tpu_torch.attack import attack as t_attack
from nerfool_tpu_torch.attack import geo_interp as t_geo
from nerfool_tpu_torch.attack.pcgrad import pcgrad_combine
from nerfool_tpu_torch.data.base import Loader
from nerfool_tpu_torch.engine import (Evaluator, load_attack_state,
                                      save_attack_state)
from nerfool_tpu_torch.models.convert import params_from_flax
from nerfool_tpu_torch.utils.cameras import transform_src_cameras

# the test tier runs several worker processes on a few cores: two math
# threads per process instead of one per core keeps them from thrashing
torch.set_num_threads(2)

TINY = {"n_views": 8, "h": H, "w": W}


# ---- gradient surgery ----

def _task_grads(rng, k=3, v=4, conflict=True):
    # few dimensions: projections then change the later dots' signs, so the
    # order of the tasks matters
    g = rng.randn(k, v, 2, 2, 1).astype(np.float32)
    if not conflict:  # every pair at a positive angle: nothing to remove
        g = np.abs(g)
    return g


@pytest.mark.parametrize("mode", ["order", "reversed", "major", "no_conflict"])
def test_pcgrad_matches_jax(mode):
    rng = np.random.RandomState(0)
    g = _task_grads(rng, conflict=mode != "no_conflict")
    if mode == "major":
        ref = j_pcgrad(jnp.asarray(g), major_idx=1)
        got = pcgrad_combine(_t(g), major_idx=1)
    elif mode == "reversed":
        # JAX draws the order from a key: hand both the same permutation
        key = jax.random.PRNGKey(3)
        order = np.asarray(jax.random.permutation(key, 3))
        assert not np.array_equal(order, np.arange(3))
        ref = j_pcgrad(jnp.asarray(g), key=key)
        got = pcgrad_combine(_t(g), order=order)
    else:
        ref = j_pcgrad(jnp.asarray(g))
        got = pcgrad_combine(_t(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)
    if mode == "no_conflict":
        np.testing.assert_allclose(got.numpy(), g.sum(0), atol=1e-6)
    else:
        assert np.abs(got.numpy() - g.sum(0)).max() > 1e-3  # surgery happened


def test_pcgrad_order_from_a_generator():
    """Without a given order a generator draws one; two tasks never depend
    on it."""
    g = _t(_task_grads(np.random.RandomState(1)))
    outs = {tuple(pcgrad_combine(
        g, generator=torch.Generator().manual_seed(s)).reshape(-1)[:4]
        .tolist()) for s in range(8)}
    assert len(outs) > 1
    two = g[:2]
    ref = pcgrad_combine(two)
    for s in range(4):
        torch.testing.assert_close(
            pcgrad_combine(two, generator=torch.Generator().manual_seed(s)),
            ref, rtol=1e-6, atol=1e-6)


# ---- camera transform, pose interpolation, the loader's skip ----

def test_transform_src_cameras_matches_jax():
    rng = np.random.RandomState(2)
    cams = orbit_cameras(4, H, W)
    rot = ((rng.rand(4, 3) * 2 - 1) * 0.2).astype(np.float32)
    trans = ((rng.rand(4, 3) * 2 - 1) * 0.1).astype(np.float32)
    ref = np.asarray(j_transform(jnp.asarray(cams), jnp.asarray(rot),
                                 jnp.asarray(trans)))
    rot_t = _t(rot).requires_grad_()
    got = transform_src_cameras(_t(cams), rot_t, _t(trans))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-6)
    assert np.abs(ref - cams).max() > 1e-2
    # zero parameters leave the cameras as they are; it differentiates
    same = transform_src_cameras(_t(cams), torch.zeros(4, 3),
                                 torch.zeros(4, 3))
    np.testing.assert_allclose(same.numpy(), cams, atol=1e-7)
    grad, = torch.autograd.grad(got.sum(), rot_t)
    assert float(grad.abs().max()) > 0


@pytest.mark.parametrize("kwargs", [
    {}, {"decouple": True, "upbound_rot": 0.5, "upbound_trans": 0.3},
    {"sample_based_on_depth": True, "beta": 0.4, "temp": 0.7},
    {"interp_upbound": 0.25}])
def test_geo_interp_matches_jax_module(kwargs):
    """The port's copy of the numpy module: the same ``RandomState`` gives
    the same poses exactly."""
    poses = orbit_cameras(7, H, W)[:, 18:34].reshape(-1, 4, 4)
    ra, rb = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(4):
        got = t_geo.sample_unseen_pose(ra, poses, **kwargs)
        ref = j_geo.sample_unseen_pose(rb, poses, **kwargs)
        np.testing.assert_array_equal(got, ref)
        assert got.shape == (4, 4) and got.dtype == np.float32


def test_loader_skip_resumes_the_stream():
    data = list(range(5))
    full = iter(Loader(data, shuffle=True, seed=0, num_workers=0,
                       infinite=True))
    head = [next(full) for _ in range(13)]
    for skip in (0, 3, 5, 7, 11):
        it = iter(Loader(data, shuffle=True, seed=0, num_workers=0,
                         infinite=True, skip=skip))
        assert [next(it) for _ in range(13 - skip)] == head[skip:]
    threaded = iter(Loader(data, shuffle=True, seed=0, num_workers=2,
                           infinite=True, skip=4))
    assert [next(threaded) for _ in range(6)] == head[4:10]


# ---- one attack step per new mode ----

def _cams_grad_cfgs(backbone):
    """Render configs whose per-tap projection lets the camera gradient
    through (GNT's semantics)."""
    jr, tr = _render_cfgs(backbone)
    return (dataclasses.replace(jr, stop_camera_grad=False),
            dataclasses.replace(tr, stop_camera_grad=False))


def _steps(backbone, n_steps=1, targets=None, rot0=None, trans0=None,
           **cfg_kw):
    """``n_steps`` steps of each package from the same delta0 (rot0, trans0),
    ray indices and PCGrad order; ``targets``: one camera per step."""
    rng = np.random.RandomState(7)
    jb, tb, target, src, delta0 = _scene(rng, backbone)
    jr, tr = _cams_grad_cfgs(backbone)
    cfg_kw = dict(h=H, w=W, n_rand=32, **cfg_kw)
    jcfg = j_attack.AttackConfig(**cfg_kw)
    tcfg = t_attack.AttackConfig(**cfg_kw)

    jsrc = {k: jnp.asarray(v) for k, v in src.items()}
    jsrc["featmaps_clean"] = jb.extract_features(jsrc["rgbs"])
    tsrc = {k: _t(v) for k, v in src.items()}
    with torch.no_grad():
        tsrc["featmaps_clean"] = tb.extract_features(tsrc["rgbs"])
    jstate = j_attack.init_attack_state(jax.random.PRNGKey(1), jcfg,
                                        jsrc["rgbs"])
    jstate = dict(jstate, delta=jnp.asarray(delta0))
    if rot0 is not None:
        jstate = dict(jstate, rot=jnp.asarray(rot0), trans=jnp.asarray(trans0))
    tstate = t_attack.init_attack_state(
        None, tcfg, tsrc["rgbs"], delta=_t(delta0),
        rot=None if rot0 is None else _t(rot0),
        trans=None if trans0 is None else _t(trans0))
    jstep = jax.jit(j_attack.make_attack_step(jb, jr, jcfg))
    tstep = t_attack.make_attack_step(tb, tr, tcfg)
    n_losses = len(jcfg.enabled_losses())
    jauxs, tauxs = [], []
    for i in range(n_steps):
        key = jax.random.PRNGKey(2 + i)
        k_sel, _, k_pc = jax.random.split(key, 3)
        sel = np.asarray(j_attack.select_ray_indices(k_sel, jcfg))
        order = np.asarray(jax.random.permutation(k_pc, n_losses))
        tgt = dict(target)
        if targets is not None:
            tgt["camera"] = targets[i]
        jstate, jaux = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                      tgt.items()}, jsrc, key)
        tstate, taux = tstep(tstate, {k: _t(v) for k, v in tgt.items()},
                             tsrc, sel=_t(sel), pc_order=order)
        jauxs.append(jaux)
        tauxs.append(taux)
    return jstate, jauxs, tstate, tauxs


def _camera_start(rng, cfg_kw):
    eps_r = cfg_kw.get("rot_epsilon", 10.0) / 180.0 * np.pi
    eps_t = cfg_kw.get("trans_epsilon", 0.1)
    rot0 = ((rng.rand(3, 3) * 2 - 1) * eps_r * 0.5).astype(np.float32)
    trans0 = ((rng.rand(3, 3) * 2 - 1) * eps_t * 0.5).astype(np.float32)
    return rot0, trans0


@pytest.mark.parametrize("use_adam", [True, False], ids=["adam", "sign_pgd"])
def test_perturb_camera_step_matches_jax(use_adam):
    """The camera-pose attack on GNT (whose projection lets the camera
    gradient through): loss, delta's gradient direction, and the rot / trans
    updates with their clamps."""
    kw = dict(perturb_camera=True, rot_epsilon=5.0, trans_epsilon=0.05)
    kw.update(dict(use_adam=True, adam_lr=1e-3) if use_adam
              else dict(adv_lr=0.01))
    rot0, trans0 = _camera_start(np.random.RandomState(3), kw)
    jstate, jaux, tstate, taux = _steps("gnt", rot0=rot0, trans0=trans0, **kw)
    np.testing.assert_allclose(float(taux[0]["loss"]),
                               float(jaux[0]["loss"]), rtol=1e-4)
    for name in ("rot", "trans"):
        got, ref = tstate[name].numpy(), np.asarray(jstate[name])
        np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=name)
        start = rot0 if name == "rot" else trans0
        assert np.abs(got - start).max() > 1e-4  # it moved
    eps_r = 5.0 / 180.0 * np.pi
    assert float(tstate["rot"].abs().max()) <= eps_r + 1e-7
    assert float(tstate["trans"].abs().max()) <= 0.05 + 1e-7
    if use_adam:
        _check_direction(tstate["m"].numpy(), jstate["opt_state"][0].mu[0])
        _check_direction(tstate["m_rot"].numpy(),
                         jstate["opt_state"][0].mu[1])
    else:
        agree = np.isclose(tstate["delta"].numpy(),
                           np.asarray(jstate["delta"]), atol=1e-7)
        assert agree.mean() > 0.9


def test_perturb_camera_no_opt_and_ibrnet_detach():
    """``perturb_camera_no_opt`` keeps rot and trans at their start; IBRNet
    detaches the source cameras, so their gradient is zero there unless the
    render config lets it through."""
    rng = np.random.RandomState(4)
    rot0, trans0 = _camera_start(rng, {})
    jb, tb, target, src, delta0 = _scene(np.random.RandomState(7), "ibrnet")
    _, tr = _render_cfgs("ibrnet")
    tsrc = {k: _t(v) for k, v in src.items()}
    ttarget = {k: _t(v) for k, v in target.items()}
    sel = _t(np.random.RandomState(0).choice(H * W, 32, replace=False))

    def one(rcfg, **kw):
        cfg = t_attack.AttackConfig(h=H, w=W, n_rand=32, perturb_camera=True,
                                    use_adam=True, adam_lr=1e-3, **kw)
        state = t_attack.init_attack_state(None, cfg, tsrc["rgbs"],
                                           delta=_t(delta0), rot=_t(rot0),
                                           trans=_t(trans0))
        return t_attack.make_attack_step(tb, rcfg, cfg)(state, ttarget, tsrc,
                                                        sel=sel)[0]

    through = dataclasses.replace(tr, stop_camera_grad=False)
    assert tr.stop_camera_grad
    frozen = one(through, perturb_camera_no_opt=True)
    detached = one(tr)
    moved = one(through)
    for state in (frozen, detached):
        np.testing.assert_array_equal(state["rot"].numpy(), rot0)
        np.testing.assert_array_equal(state["trans"].numpy(), trans0)
        assert float(state["m_rot"].abs().max()) == 0
        assert float((state["delta"] - _t(delta0)).abs().max()) > 0
    assert float((moved["rot"] - _t(rot0)).abs().max()) > 1e-4


@pytest.mark.parametrize("major_loss", ["", "rgb"], ids=["pairwise", "major"])
def test_pcgrad_step_matches_jax(major_loss):
    """``use_pcgrad`` with two loss terms (rgb and depth variance, IBRNet):
    with two tasks the projection order cannot matter. Every term's value and
    the combined gradient's direction against the JAX step."""
    jstate, jaux, tstate, taux = _steps(
        "ibrnet", use_adam=True, adam_lr=1e-3, use_pcgrad=True,
        major_loss=major_loss, depth_var_loss=0.1)
    assert set(taux[0]) == {"loss", "rgb", "depth_var"}
    # depth variance is a difference of near-equal second moments of the
    # compositing weights: it amplifies the renders' ~1e-5 agreement to a few
    # 1e-4 of its value (1.04e-4 here)
    for name, tol in (("loss", 1e-4), ("rgb", 1e-4), ("depth_var", 3e-4)):
        np.testing.assert_allclose(float(taux[0][name]),
                                   float(jaux[0][name]), rtol=tol,
                                   atol=1e-7, err_msg=name)
    _check_direction(tstate["m"].numpy(), jstate["opt_state"][0].mu[0])


def test_three_universal_iterations_match_jax():
    """Three iterations on one source set over three target cameras (between
    the sources: a target that coincides with a source makes the
    ray-difference normalisation ill conditioned in both packages), each
    with the rays JAX draws. Adam's first steps are lr * sign(g), and the
    entries whose tiny gradient differs in sign between the packages put the
    two deltas 2 lr apart, which the random-weight ResUNet amplifies (at lr
    1e-3 the second loss moves by 1%, at 1e-5 by 5e-4). So the step size
    here is 1e-6. The first loss agrees to 1e-4, the later ones to 5e-4 (2.5e-4
    measured at the third: a batch with samples at a source image's border,
    where the validity mask is discontinuous, is that sensitive to the
    renders' ~1e-5 agreement); the state (step count, moments) is threaded
    alike, and delta moved by the three steps."""
    targets = orbit_cameras(8, H, W)[[1, 3, 5]]
    lr = 1e-6
    jstate, jaux, tstate, taux = _steps(
        "ibrnet", n_steps=3, targets=targets, use_adam=True, adam_lr=lr)
    for i, tol in enumerate((1e-4, 5e-4, 5e-4)):
        np.testing.assert_allclose(float(taux[i]["loss"]),
                                   float(jaux[i]["loss"]), rtol=tol,
                                   err_msg=f"iteration {i}")
    losses = [float(a["loss"]) for a in taux]
    assert len({round(x, 4) for x in losses}) == 3  # three different targets
    assert tstate["step"] == int(jstate["step"]) == 3
    _check_direction(tstate["m"].numpy(), jstate["opt_state"][0].mu[0])
    moved = (tstate["delta"] - _scene_delta0()).abs()
    assert 2 * lr < float(moved.max()) <= 3.01 * lr
    close = np.isclose(tstate["delta"].numpy(), np.asarray(jstate["delta"]),
                       atol=lr / 2)
    assert close.mean() > 0.85


def _scene_delta0():
    """The start ``_steps`` gives both packages."""
    return _t(_scene(np.random.RandomState(7), "ibrnet")[4])


def test_init_attack_state_camera_parameters():
    src = torch.rand(3, 6, 7, 3)
    gen = torch.Generator().manual_seed(0)
    cfg = t_attack.AttackConfig(h=6, w=7, perturb_camera=True,
                                rot_epsilon=5.0, trans_epsilon=0.05)
    state = t_attack.init_attack_state(gen, cfg, src)
    assert state["rot"].shape == state["trans"].shape == (3, 3)
    assert 0 < float(state["rot"].abs().max()) <= cfg.rot_eps_rad
    assert 0 < float(state["trans"].abs().max()) <= 0.05
    assert cfg.rot_eps_rad == pytest.approx(5.0 / 180.0 * np.pi)
    for kw in ({"zero_camera_init": True}, {"perturb_camera": False}):
        state = t_attack.init_attack_state(
            gen, dataclasses.replace(cfg, **kw), src)
        assert not state["rot"].any() and not state["trans"].any()
    assert set(state) == {"delta", "rot", "trans", "step", "m", "v", "m_rot",
                          "v_rot", "m_trans", "v_trans"}


# ---- the evaluator: universal loop, checkpoint, global-source rows ----

def _argv(tmp_path, *extra):
    return ["--eval_dataset", "synthetic", "--backbone", "ibrnet",
            "--N_samples", "12", "--N_importance", "0", "--chunk_size", "256",
            "--num_source_views", "4", "--rootdir", str(tmp_path),
            "--workers", "0", "--use_bspg", "False", "--device", "cpu",
            "--dataset_kwargs", json.dumps(TINY), "--N_rand", "32", *extra]


ADAM = ("--use_adam", "--adam_lr", "1e-3", "--adv_lr", "1", "--epsilon", "8")


def test_universal_cli_runs_from_the_global_source_set(tmp_path, monkeypatch):
    """No ``--view_specific``: one attack, then every test view rendered
    from the global source set with the same perturbation."""
    monkeypatch.chdir(tmp_path)
    args = port_eval_adv.parse_args(_argv(
        tmp_path, *ADAM, "--adv_iters", "3", "--use_pseudo_gt",
        "--use_center_view"))
    ev = Evaluator(args, dataset_kwargs=TINY, device="cpu", seed=0)
    seen = []
    real = ev.render_view
    ev.render_view = lambda data, src, delta=None, src_cameras=None: (
        seen.append((src["rgbs"], delta)), real(data, src, delta,
                                                src_cameras))[1]
    res = ev.evaluate(verbose=False)["synthetic"]
    rows = [v for v in res.values() if isinstance(v, dict)]
    assert len(rows) == len(ev.test_dataset) == 2
    assert res["attack_seconds"] > 0 and len(ev.last_attack["losses"]) == 3
    assert all("attack_seconds" not in r for r in rows)
    assert np.isfinite([r["coarse_psnr"] for r in rows]).all()
    glb = ev.global_src()["rgbs"]
    for rgbs, delta in seen:  # one source set, one delta
        assert torch.equal(rgbs, glb) and delta is seen[0][1]
    delta = seen[0][1]
    assert 0 < float(delta.abs().max()) <= 8 / 255 + 1e-7
    assert float((glb + delta).min()) >= -1e-7
    assert float((glb + delta).max()) <= 1 + 1e-7
    # the center-view set is not the first view's nearest-view set
    own = ev._make_src(ev.test_dataset[0])["rgbs"]
    assert not torch.equal(own, glb)


def test_global_source_clean_rows_match_jax_evaluator(tmp_path):
    """``--no_attack`` without ``--view_specific``: every test view from the
    global source set, against the JAX evaluator's rows."""
    jb = j_create_model(backbone="ibrnet", rng_key=jax.random.PRNGKey(0))
    ckpt = tmp_path / "model.pth"
    torch.save(params_from_flax(jax.tree.map(np.asarray, jb.params)), ckpt)
    args = _engine_args(tmp_path, no_attack=True, use_center_view=True)
    ref = AdvEvaluator(args, bundle=jb, dataset_kwargs=TINY).evaluate(
        verbose=False, save_images=False)["synthetic"]
    out = port_eval_adv.main(_argv(
        tmp_path, "--no_attack", "--use_center_view", "--ckpt_path",
        str(ckpt)))["synthetic"]
    views = [k for k in ref if k.startswith("synthetic_")]
    assert len(views) == 2 and sorted(views) == sorted(
        k for k in out if k.startswith("synthetic_"))
    for k in views:
        assert abs(out[k]["coarse_psnr"] - ref[k]["coarse_psnr"]) < 1e-3, k
        assert abs(out[k]["coarse_ssim"] - ref[k]["coarse_ssim"]) < 1e-4, k
    # and they are not the per-view source sets' rows
    own = port_eval.main(_argv(tmp_path, "--ckpt_path", str(ckpt))
                         )["synthetic"]
    assert any(abs(own[k]["coarse_psnr"] - out[k]["coarse_psnr"]) > 1e-3
               for k in views)


def test_zero_epsilon_universal_reproduces_global_clean_rows(tmp_path,
                                                             monkeypatch):
    monkeypatch.chdir(tmp_path)
    clean = port_eval_adv.main(_argv(tmp_path, "--no_attack",
                                     "--use_center_view"))["synthetic"]
    adv = port_eval_adv.main(_argv(
        tmp_path, *ADAM[:-1], "0", "--adv_iters", "2",
        "--use_center_view"))["synthetic"]
    for k, row in clean.items():
        if isinstance(row, dict):
            for name in ("coarse_psnr", "coarse_ssim"):
                assert adv[k][name] == row[name], (k, name)


@pytest.mark.parametrize("flags", [
    ("--use_unseen_views",), ("--perturb_camera", "--backbone", "gnt",
                              "--trans_depth", "2", "--ret_alpha")],
    ids=["unseen_views", "pose_attack_gnt"])
def test_checkpoint_then_resume_equals_the_unbroken_run(tmp_path, monkeypatch,
                                                        flags):
    """4 iterations in one run against 2, a checkpoint, and a resumed run to
    4: the same state exactly (delta, camera parameters, Adam moments, the
    generator's and the pose stream's positions, the loader's place)."""
    monkeypatch.chdir(tmp_path)

    def run(n_iters, ckpt):
        args = port_eval_adv.parse_args(_argv(
            tmp_path, *ADAM, "--adv_iters", str(n_iters), "--i_attack_ckpt",
            "2", *flags))
        ev = Evaluator(args, dataset_kwargs=TINY, device="cpu", seed=0)
        out = ev.attack_universal(ckpt_path=str(ckpt))
        return out, ev

    (delta_a, _, cams_a), ev_a = run(4, tmp_path / "a.pt")
    assert len(ev_a.last_attack["losses"]) == 4
    run(2, tmp_path / "b.pt")
    state, meta = load_attack_state(tmp_path / "b.pt")
    assert meta["iters_done"] == 2 and state["step"] == 2
    (delta_b, _, cams_b), ev_b = run(4, tmp_path / "b.pt")
    assert len(ev_b.last_attack["losses"]) == 2  # only the resumed part ran
    assert torch.equal(delta_a, delta_b) and torch.equal(cams_a, cams_b)
    torch.testing.assert_close(ev_a.last_attack["losses"][2:],
                               ev_b.last_attack["losses"], rtol=0, atol=0)
    final_a, meta_a = load_attack_state(tmp_path / "a.pt")
    final_b, meta_b = load_attack_state(tmp_path / "b.pt")
    assert meta_a["iters_done"] == meta_b["iters_done"] == 4
    for k, v in final_a.items():
        assert (torch.equal(v, final_b[k]) if torch.is_tensor(v)
                else v == final_b[k]), k
    if "--perturb_camera" in flags:
        assert float((cams_a - ev_a.global_src()["cameras"]).abs().max()) > 0


def test_attack_state_round_trip(tmp_path):
    state = {"delta": torch.rand(2, 3), "rot": torch.zeros(2, 3), "step": 5}
    path = tmp_path / "s.pt"
    save_attack_state(path, state, {"iters_done": 5})
    got, meta = load_attack_state(path)
    assert meta == {"iters_done": 5} and got["step"] == 5
    assert torch.equal(got["delta"], state["delta"])
    assert os.listdir(tmp_path) == ["s.pt"]  # no temporary file left


def test_pose_attack_renders_per_tap(tmp_path, monkeypatch, capsys):
    """``--perturb_camera`` moves the source cameras out of the BSPG plan:
    its whole-frame renders take the per-tap gather and say so once; without
    it a plan that cannot be made takes the per-tap gather too, as the JAX
    evaluator does, and says why once."""
    monkeypatch.chdir(tmp_path)
    argv = _argv(tmp_path, *ADAM, "--adv_iters", "1", "--perturb_camera",
                 "--max_views", "2", "--use_bspg", "True")
    args = port_eval_adv.parse_args(argv)
    assert args.use_bspg
    ev = Evaluator(args, dataset_kwargs=TINY, device="cpu", seed=0)
    res = ev.evaluate(verbose=False)["synthetic"]
    assert ev.view_render_cfg(4).bspg_specs is None
    assert np.isfinite(res["coarse_mean_psnr"])
    assert capsys.readouterr().out.count("per-tap") == 1
    ev.args.perturb_camera = False
    for _ in range(2):  # 24x32 frames are too small to plan
        assert ev.view_render_cfg(4).bspg_specs is None
    assert capsys.readouterr().out.splitlines() == [
        "whole-frame renders take the per-tap gather: no admissible patch "
        "size covers the epipolar spans of this camera set"]


@pytest.mark.parametrize("flags,ran", [
    (("--use_purification",), {"rgb", "purification"}),
    (("--def_random_noise", "0.1"), {"rgb", "random_noise"}),
    (("--geo_noise", "0.1"), {"rgb", "geo_noise"}),
    (("--no_attack", "--use_clean_color"), {"use_clean_color"}),
    (("--use_clean_density",), {"rgb", "use_clean_density"}),
    (("--depth_consistency_loss", "0.5"), {"rgb", "depth_cons"}),
    (("--camera_consistency_loss", "0.5"), {"rgb", "camera_cons"}),
    (("--ds_rgb",), {"rgb"}),
])
def test_universal_defense_and_consistency_options_run_by_name(
        tmp_path, monkeypatch, flags, ran):
    """Each flag set in a tiny universal ``eval_adv`` run (1 iteration on
    the global source set, 1 purification step) gives finite rows and
    reports the terms, defenses and render modes it ran."""
    monkeypatch.chdir(tmp_path)
    ev, _ = _run_tiny(tmp_path, _argv(tmp_path, "--adv_iters", "1",
                                      "--purif_iters", "1", *flags), TINY)
    assert _ran(ev) == ran
