"""The port's multi-view-consistency attack terms, hybrid clean/attacked
renders, ``geo_noise`` and the defenses (``nerfool_tpu_torch/attack/warp.py``,
``attack/attack.py``, ``render/render_rays.py``, ``attack/purify.py``)
against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages; weights are the
JAX bundle's, carried over by ``convert.params_from_flax``. JAX keys and
torch generators never agree bit for bit, so each port call is handed what
JAX draws: the ray indices, the source views of the consistency terms, the
``ds_rgb`` rays, the ``geo_noise`` draws, the purification's initial value.

Warps land on integer pixels, so a landing coordinate within rounding of an
integer may fall on either side in the two packages. The depth maps given to
the warps are nudged until every landing coordinate lies at least 2e-4 of a
pixel from an integer (``_clear_of_integers``, in float64); f32 rounding
moves them by ~1e-5. Pixel indices are then held equal.

Tolerances: the warp's coordinates and depths 1e-5 relative (f32 matrix
inverses and products in a different order); the z-buffer's tie-break
exactly; the f32 attack steps' loss and every term 1e-4 relative and the
gradient by direction (``_check_direction``, as in test_torch_attack.py);
renders, steps and purification in float64 (JAX under ``jax.enable_x64``,
the port's modules ``.double()``) 1e-9, or for GNT 1e-6 (its positional
encodings are float32 in both packages), as the JAX package's x64 tests
hold it against the reference.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers import orbit_cameras, synthetic_scene

from nerfool_tpu.attack import attack as j_attack
from nerfool_tpu.attack import purify as j_purify
from nerfool_tpu.attack import warp as j_warp
from nerfool_tpu.render import render_rays as j_rr
from nerfool_tpu.utils.cameras import get_rays as j_get_rays

from nerfool_tpu_torch.attack import attack as t_attack
from nerfool_tpu_torch.attack import purify as t_purify
from nerfool_tpu_torch.attack import warp as t_warp
from nerfool_tpu_torch.render import render_rays as t_rr

from tests.test_torch_attack import (H, W, _check_direction, _render_cfgs,
                                     _scene)

# the test tier runs several worker processes on a few cores: two math
# threads per process instead of one per core keeps them from thrashing
torch.set_num_threads(2)


def _t(x, dtype=None):
    x = torch.as_tensor(np.array(x))
    return x if dtype is None else x.to(dtype)


def _kc(cam):
    """[3, 3] intrinsics and [4, 4] c2w of a camera vector (numpy)."""
    cam = np.asarray(cam, np.float64)
    return cam[2:18].reshape(4, 4)[:3, :3], cam[18:34].reshape(4, 4)


def _landing64(depth, k_from, e_from, k_to, e_to):
    """project_with_depth in float64 numpy: (x, y) landing coordinates."""
    h, w = depth.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)]).astype(np.float64)
    xyz = np.linalg.inv(k_from) @ (pix * depth.reshape(1, -1).astype(
        np.float64))
    xyz = (np.linalg.inv(e_to) @ e_from @ np.vstack([xyz, np.ones(h * w)]))[:3]
    k_xyz = k_to @ xyz
    return k_xyz[0] / (k_xyz[2] + 1e-9), k_xyz[1] / (k_xyz[2] + 1e-9)


def _clear_of_integers(depth, warps, margin=2e-4):
    """``depth`` (float32) nudged until, for each warp (k_from, c2w_from,
    k_to, c2w_to) in ``warps``, every landing coordinate inside the frame
    lies at least ``margin`` from an integer."""
    depth = np.asarray(depth, np.float32).copy()
    h, w = depth.shape
    for _ in range(200):
        bad = np.zeros(h * w, bool)
        for warp in warps:
            x, y = _landing64(depth, *warp)
            for c, n in ((x, w), (y, h)):
                near = np.abs(c - np.round(c)) < margin
                bad |= near & (c > -margin) & (c < n - 1 + margin)
        if not bad.any():
            return depth
        depth.reshape(-1)[bad] *= np.float32(1.002)
    raise AssertionError("landing coordinates stay near integers")


# ---- warp ----

def _warp_inputs(seed=0, h=12, w=16):
    rng = np.random.RandomState(seed)
    cams = orbit_cameras(2, h, w)
    (k_ref, e_ref), (k_src, e_src) = _kc(cams[0]), _kc(cams[1])
    depth = (rng.rand(h, w) * 2 + 3.0).astype(np.float32)
    depth = _clear_of_integers(depth, [(k_ref, e_ref, k_src, e_src)])
    rgb = rng.rand(h, w, 3).astype(np.float32)
    mats = [m.astype(np.float32) for m in (k_ref, e_ref, k_src, e_src)]
    sel = np.sort(rng.choice(h * w, 20, replace=False))
    return depth, rgb, mats, sel


def test_project_with_depth_matches_jax():
    depth, _, mats, _ = _warp_inputs()
    got = t_warp.project_with_depth(_t(depth), *map(_t, mats))
    ref = j_warp.project_with_depth(jnp.asarray(depth),
                                    *map(jnp.asarray, mats))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("mode", ["src2tar", "tar2src", "full_image"])
def test_forward_warp_matches_jax(mode):
    """Both modes and ``derive_full_image``: the landing pixel indices
    equal, the z-buffered values 1e-5."""
    depth, rgb, mats, sel = _warp_inputs()
    kw = dict(src2tar=mode != "tar2src",
              derive_full_image=mode == "full_image")
    got = t_warp.forward_warp(_t(sel), _t(rgb), _t(depth), *map(_t, mats),
                              **kw)
    ref = j_warp.forward_warp(jnp.asarray(sel), jnp.asarray(rgb),
                              jnp.asarray(depth), *map(jnp.asarray, mats),
                              **kw)
    assert len(got) == len(ref)
    if mode == "tar2src":
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
    # where something landed
    np.testing.assert_array_equal(got[1].numpy() > 0, np.asarray(ref[1]) > 0)
    assert (got[3] > 0).any()
    for g, r in zip(got[:4], ref[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)
    # the depth-only form the depth-consistency term uses
    d_only = t_warp.forward_warp(_t(sel), None, _t(depth), *map(_t, mats),
                                 **kw)
    assert d_only[0] is None and d_only[2] is None
    assert torch.equal(d_only[3], got[3])


def test_zbuffer_ties_go_to_the_lowest_source_index():
    """Equal depths landing on one pixel: the lowest source index wins, as
    in JAX (and the reference's loop); gradients reach the winners only."""
    tgt = np.array([3, 1, 3, 3, 0, 1, 5], np.int64)
    depth = np.array([2.0, 1.0, 1.5, 1.5, 4.0, 1.0, 3.0], np.float32)
    rgb = np.arange(21, dtype=np.float32).reshape(7, 3)
    d = _t(depth).requires_grad_(True)
    got_rgb, got_depth = t_warp._zbuffer_scatter(_t(tgt), d, _t(rgb), 8)
    ref_rgb, ref_depth = j_warp._zbuffer_scatter(
        jnp.asarray(tgt, jnp.int32), jnp.asarray(depth), jnp.asarray(rgb), 8)
    np.testing.assert_array_equal(got_depth.detach().numpy(),
                                  np.asarray(ref_depth))
    np.testing.assert_array_equal(got_rgb.numpy(), np.asarray(ref_rgb))
    np.testing.assert_array_equal(got_rgb.numpy()[[1, 3]], rgb[[1, 2]])
    (g,) = torch.autograd.grad(got_depth.sum(), d)
    j_g = jax.grad(lambda x: j_warp._zbuffer_scatter(
        jnp.asarray(tgt, jnp.int32), x, jnp.asarray(rgb), 8)[1].sum())(
        jnp.asarray(depth))
    np.testing.assert_array_equal(g.numpy(), np.asarray(j_g))
    np.testing.assert_array_equal(g.numpy(), [0, 1, 1, 0, 1, 0, 1])


# ---- hybrid renders and geo_noise ----

HYBRID = [(True, False), (False, True), (True, True)]


def _render_both(backbone, ucc, ucd, n_imp, geo_noise=0.0, f64=True):
    """One ray batch through JAX's and the port's render_rays with the same
    weights, features, clean features and noise key / draws."""
    rng = np.random.RandomState(31 if backbone == "ibrnet" else 41)
    target_cam, src_rgbs, src_cams, feats, depth_range = synthetic_scene(
        rng, h=H, w=W)
    feats_clean = tuple(f + 0.3 * rng.randn(*f.shape).astype(np.float32)
                        for f in feats)
    rays_o, rays_d = j_get_rays(H, W, jnp.asarray(target_cam[2:18]).reshape(
        4, 4), jnp.asarray(target_cam[18:34]).reshape(4, 4))
    sel = rng.choice(H * W, 29, replace=False)
    jr, tr = _render_cfgs(backbone, n_imp)
    mix = dict(use_clean_color=ucc, use_clean_density=ucd,
               geo_noise=geo_noise)
    jr = dataclasses.replace(jr, inv_uniform=True, n_importance=n_imp,
                             compute_dtype="float64" if f64 else "float32",
                             **mix)
    tr = dataclasses.replace(tr, inv_uniform=True, n_importance=n_imp, **mix)
    jb, tb, *_ = _scene(np.random.RandomState(7), backbone)
    np_dt = np.float64 if f64 else np.float32
    t_dt = torch.float64 if f64 else torch.float32
    key = jax.random.PRNGKey(3)
    arrays = dict(ray_o=np.asarray(rays_o)[sel], ray_d=np.asarray(rays_d)[sel],
                  depth_range=depth_range, camera=target_cam[None])
    with jax.enable_x64(f64):
        params = jax.tree.map(lambda a: jnp.asarray(a, np_dt),
                              jb.render_params)
        jbatch = {k: jnp.asarray(v, np_dt) for k, v in arrays.items()}
        ref = j_rr.render_rays(
            params, jb.modules, jbatch,
            tuple(jnp.asarray(f, np_dt) for f in feats), jr,
            src_rgbs=jnp.asarray(src_rgbs, np_dt),
            src_cameras=jnp.asarray(src_cams, np_dt), key=key,
            featmaps_clean=tuple(jnp.asarray(f, np_dt) for f in feats_clean))
        keys = jax.random.split(key, 4)
        noise = None
        if geo_noise:
            n_s = jr.n_samples
            noise = [_t(jax.random.normal(keys[1], (29, n_s), np_dt)),
                     _t(jax.random.normal(keys[3], (29, n_s + n_imp), np_dt))]
        ref = jax.tree.map(np.asarray, ref)
    nets = {k: (None if m is None else m.to(t_dt)) for k, m in tb.nets.items()}
    got = t_rr.render_rays(
        nets, {k: _t(v, t_dt) for k, v in arrays.items()},
        tuple(_t(f, t_dt) for f in feats), tr, _t(src_rgbs, t_dt),
        _t(src_cams, t_dt), featmaps_clean=tuple(_t(f, t_dt)
                                                 for f in feats_clean),
        noise=noise)
    return got, ref


def _check_levels(got, ref, keys, atol):
    for level in ("outputs_coarse", "outputs_fine"):
        assert (got[level] is None) == (ref[level] is None), level
        if ref[level] is None:
            continue
        for k in keys:
            np.testing.assert_allclose(got[level][k].detach().numpy(),
                                       ref[level][k], rtol=0, atol=atol,
                                       err_msg=f"{level}/{k}")


@pytest.mark.parametrize("ucc,ucd", HYBRID)
def test_ibrnet_hybrid_render_matches_jax(ucc, ucd):
    """IBRNet mixes raw colour and sigma at both levels (float64)."""
    got, ref = _render_both("ibrnet", ucc, ucd, n_imp=6)
    _check_levels(got, ref, ("rgb", "depth", "weights", "alpha"), 1e-9)


@pytest.mark.parametrize("ucc,ucd", HYBRID)
@pytest.mark.parametrize("n_imp", [0, 6])
def test_gnt_hybrid_render_matches_jax(ucc, ucd, n_imp):
    """GNT mixes the coarse level only and keeps the attacked depth; the
    fine level samples the mixed weights (float64). 1e-6, the bound of
    tests/test_render_hybrid_x64.py: GNT computes its positional encodings
    of float64 points in float32 in both packages, whose sines differ by a
    unit in the last place."""
    got, ref = _render_both("gnt", ucc, ucd, n_imp=n_imp)
    _check_levels(got, ref, ("rgb", "depth", "weights"), 1e-6)


@pytest.mark.parametrize("ucc,ucd", [(False, False), (True, True)])
def test_geo_noise_matches_jax(ucc, ucd):
    """IBRNet's sigma noise with JAX's draws handed in (float64), plain and
    on a hybrid render; GNT takes none."""
    got, ref = _render_both("ibrnet", ucc, ucd, n_imp=6, geo_noise=0.5)
    _check_levels(got, ref, ("rgb", "depth", "weights", "alpha"), 1e-9)
    base, _ = _render_both("ibrnet", ucc, ucd, n_imp=6)
    assert not torch.allclose(base["outputs_coarse"]["alpha"],
                              got["outputs_coarse"]["alpha"])


# ---- the consistency terms of the attack step ----

def _smooth_depths(v, h=H, w=W):
    """Smooth ground-truth depths inside the scene's depth range: [v, h, w]."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([3.0 + np.cos(xx / 6.0 + i) + 0.4 * np.sin(yy / 4.0)
                     for i in range(v)]).astype(np.float32)


def _scaled(cam, rf):
    """(k, c2w) of a camera vector with the ``ds_rgb`` scaling of the
    source's intrinsics (``rf`` = 1: none)."""
    k, e = _kc(cam)
    return k * rf + np.diag([0.0, 0.0, 1.0 - rf]), e


def _cons_both(backbone, f64=False, rot0=None, trans0=None, **cfg_kw):
    """One attack step of each package with the consistency terms, from the
    same delta0 (rot0, trans0), ray indices, source views and ``ds_rgb``
    rays; depths cleared of integer landings for the warps the step runs."""
    rng = np.random.RandomState(7)
    jb, tb, target, src, delta0 = _scene(rng, backbone)
    jr, tr = _render_cfgs(backbone)
    if cfg_kw.get("perturb_camera_no_detach"):
        jr = dataclasses.replace(jr, stop_camera_grad=False)
        tr = dataclasses.replace(tr, stop_camera_grad=False)
    cfg_kw = dict(h=H, w=W, n_rand=32, use_adam=True, adam_lr=1e-3, **cfg_kw)
    jcfg = j_attack.AttackConfig(**cfg_kw)
    tcfg = t_attack.AttackConfig(**cfg_kw)
    n_src = src["rgbs"].shape[0]
    np_dt = np.float64 if f64 else np.float32
    t_dt = torch.float64 if f64 else torch.float32
    key = jax.random.PRNGKey(2)
    with jax.enable_x64(f64):  # x64 draws other bits: draw under it
        k_sel, k_render, _ = jax.random.split(key, 3)
        sel = np.asarray(j_attack.select_ray_indices(k_sel, jcfg))
        draw = lambda k: int(jax.random.randint(k, (), 0, n_src))
        d_id = draw(jax.random.fold_in(k_render, 17))
        c_id = draw(jax.random.fold_in(k_render, 23))
        rf = jcfg.resize_factor
        sel_half = np.asarray(j_attack.select_ray_indices(
            jax.random.fold_in(k_render, 19), dataclasses.replace(
                jcfg, h=int(H * rf), w=int(W * rf))))
    depths = _smooth_depths(n_src)
    tar_depth = _smooth_depths(1)[0] + 0.5
    warps = {i: [] for i in range(n_src)}
    tar = _kc(target["camera"])
    if jcfg.depth_consistency_loss > 0:
        r = rf if jcfg.ds_rgb else 1.0
        warps[d_id].append((*_scaled(src["cameras"][d_id], r),
                            tar[0] * np.array([[r], [r], [1.0]]), tar[1]))
    if jcfg.camera_consistency_loss > 0:
        warps[c_id].append((*_kc(src["cameras"][c_id]), *tar))
        tar_depth = _clear_of_integers(
            tar_depth, [(*tar, *_kc(src["cameras"][c_id]))])
    src = dict(src, depths=np.stack([
        _clear_of_integers(d, warps[i]) for i, d in enumerate(depths)]))
    target = dict(target, depth=tar_depth.reshape(-1))

    cast = lambda d: {k: v.astype(np_dt) if v.dtype.kind == "f" else v
                      for k, v in d.items()}
    target, src, delta0 = cast(target), cast(src), delta0.astype(np_dt)
    with jax.enable_x64(f64):
        if f64:
            jb = dataclasses.replace(jb, params=jax.tree.map(
                lambda a: jnp.asarray(a, jnp.float64), jb.params))
        jsrc = {k: jnp.asarray(v) for k, v in src.items()}
        jsrc["featmaps_clean"] = jb.extract_features(jsrc["rgbs"])
        jtarget = {k: jnp.asarray(v) for k, v in target.items()}
        jtarget["depth_full"] = jtarget["depth"]
        jstate = dict(j_attack.init_attack_state(
            jax.random.PRNGKey(1), jcfg, jsrc["rgbs"]),
            delta=jnp.asarray(delta0))
        if rot0 is not None:
            jstate = dict(jstate, rot=jnp.asarray(rot0, np_dt),
                          trans=jnp.asarray(trans0, np_dt))
        jstate, jaux = jax.jit(j_attack.make_attack_step(jb, jr, jcfg))(
            jstate, jtarget, jsrc, key)
        jstate = jax.tree.map(np.asarray, jstate)
        jaux = {k: float(v) for k, v in jaux.items()}
    if f64:
        for m in (tb.feature_net, tb.net_coarse, tb.net_fine):
            if m is not None:
                m.double()
    tsrc = {k: _t(v) for k, v in src.items()}
    with torch.no_grad():
        tsrc["featmaps_clean"] = tb.extract_features(tsrc["rgbs"])
    tstate = t_attack.init_attack_state(
        None, tcfg, tsrc["rgbs"], delta=_t(delta0),
        rot=None if rot0 is None else _t(rot0, t_dt),
        trans=None if trans0 is None else _t(trans0, t_dt))
    tstate, taux = t_attack.make_attack_step(tb, tr, tcfg)(
        tstate, {k: _t(v) for k, v in target.items()}, tsrc, sel=_t(sel),
        depth_src_id=d_id, camera_src_id=c_id, sel_half=_t(sel_half))
    return jstate, jaux, tstate, {k: float(v) for k, v in taux.items()}


def _check_terms(taux, jaux, rtol):
    assert set(taux) == set(jaux)
    for name in taux:
        np.testing.assert_allclose(taux[name], jaux[name], rtol=rtol,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("ds_rgb", [False, True], ids=["full", "ds_rgb"])
def test_depth_consistency_step_matches_jax(ds_rgb):
    """``--depth_consistency_loss``: the source depth warped into the target
    against the main render's depth, or with ``--ds_rgb`` against a second
    render at half resolution with its own rays; loss and terms 1e-4, the
    gradient by direction."""
    jstate, jaux, tstate, taux = _cons_both(
        "ibrnet", depth_consistency_loss=0.5, ds_rgb=ds_rgb)
    assert set(taux) == {"loss", "rgb", "depth_cons"} and taux["depth_cons"]
    _check_terms(taux, jaux, 1e-4)
    _check_direction(tstate["m"].numpy(), jstate["opt_state"][0].mu[0])


@pytest.mark.parametrize("no_detach", [False, True],
                         ids=["detach", "no_detach"])
def test_camera_consistency_step_matches_jax(no_detach):
    """``--camera_consistency_loss`` with all three weights under the
    camera-pose attack (cameras from zero, so the f32 landings are those
    cleared): loss and terms 1e-4, the gradients of delta and of the camera
    rotation by direction. ``--perturb_camera_no_detach`` also lets the
    render's rgb and the source cameras carry gradient."""
    jstate, jaux, tstate, taux = _cons_both(
        "ibrnet", perturb_camera=True, zero_camera_init=True,
        camera_consistency_loss=0.5, cam_src2tar=1.0, cam_tar2src=1.0,
        cam_depth=0.1, perturb_camera_no_detach=no_detach)
    assert set(taux) == {"loss", "rgb", "camera_cons"} and taux["camera_cons"]
    _check_terms(taux, jaux, 1e-4)
    _check_direction(tstate["m"].numpy(), jstate["opt_state"][0].mu[0])
    _check_direction(tstate["m_rot"].numpy(), jstate["opt_state"][0].mu[1])
    assert float(tstate["m_trans"].abs().max()) > 0


def test_consistency_step_float64_matches_jax():
    """Both consistency terms (``ds_rgb``) in one float64 step of the
    camera-pose attack from a non-zero camera start, against JAX under x64:
    terms 1e-9, the gradients (Adam's first moments) 1e-9 of their scale;
    delta, rot and trans 1e-8, 1e-5 of the step size: Adam's first step
    divides by |g| + 1e-8, which turns the gradients' 1e-11 agreement into
    ~2e-9 where |g| is near 1e-8."""
    rot0 = np.array([[0.01, -0.02, 0.015], [0.0, 0.01, -0.01],
                     [-0.02, 0.005, 0.01]])
    trans0 = np.array([[0.01, 0.0, -0.01], [0.005, -0.01, 0.0],
                       [0.0, 0.01, 0.005]])
    jstate, jaux, tstate, taux = _cons_both(
        "ibrnet", f64=True, rot0=rot0, trans0=trans0, perturb_camera=True,
        depth_consistency_loss=0.5, ds_rgb=True, camera_consistency_loss=0.5,
        cam_src2tar=1.0, cam_tar2src=1.0, cam_depth=0.1)
    assert set(taux) == {"loss", "rgb", "depth_cons", "camera_cons"}
    _check_terms(taux, jaux, 1e-9)
    mu = jstate["opt_state"][0].mu
    for name, ref in (("m", mu[0]), ("m_rot", mu[1]), ("m_trans", mu[2])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(tstate[name].numpy(), ref, rtol=0,
                                   atol=1e-9 * np.abs(ref).max(),
                                   err_msg=name)
    for name in ("delta", "rot", "trans"):
        np.testing.assert_allclose(tstate[name].numpy(), jstate[name],
                                   rtol=0, atol=1e-8, err_msg=name)


# ---- purification and the noise defense ----

def _purify_both(monkeypatch, f64, n_steps, use_self_purification=True,
                 purif_consistency_loss=0.1):
    """``n_steps`` purification steps of each package on GNT from the same
    purif init, frozen delta, ray indices and source views; the depths
    cleared of integer landings for the warps the steps run.

    The rays are drawn away from the frame's border: self-purification
    renders a source view's own camera, whose samples project back onto the
    ray's pixel within rounding, and on the border the in-frame test then
    goes either way. JAX's step is given them through its
    ``select_ray_indices`` (and runs eagerly, so that each step reads its
    own)."""
    jb, tb, target, src, delta0 = _scene(np.random.RandomState(7), "gnt")
    jr, tr = _render_cfgs("gnt")
    kw = dict(h=H, w=W, n_rand=32, purif_iters=n_steps, adam_lr=1e-3,
              lr_step_size=2, lr_gamma=0.5,
              use_self_purification=use_self_purification,
              purif_consistency_loss=purif_consistency_loss)
    jcfg, tcfg = j_purify.PurifyConfig(**kw), t_purify.PurifyConfig(**kw)
    n_src = src["rgbs"].shape[0]
    np_dt = np.float64 if f64 else np.float32
    t_dt = torch.float64 if f64 else torch.float32
    # keys whose two source views differ: a view warped into its own camera
    # lands within rounding of integers everywhere, in either package
    keys, draws = [], []
    with jax.enable_x64(f64):
        seed = 10
        while len(keys) < n_steps:
            key = jax.random.PRNGKey(seed)
            seed += 1
            _, k_view, _ = jax.random.split(key, 3)
            view = int(jax.random.randint(k_view, (), 0, n_src))
            cons = int(jax.random.randint(jax.random.fold_in(k_view, 1), (),
                                          0, n_src))
            if view != cons:
                keys.append(key)
                draws.append((None, view, cons))
    rng = np.random.RandomState(8)
    inner = (np.arange(1, H - 1)[:, None] * W + np.arange(1, W - 1)).ravel()
    draws = [(rng.choice(inner, 32, replace=False), view, cons)
             for _, view, cons in draws]
    sels = iter([jnp.asarray(sel) for sel, _, _ in draws])
    monkeypatch.setattr(j_purify, "select_ray_indices",
                        lambda key, cfg: next(sels))
    warps = {i: [] for i in range(n_src)}
    for _, view, cons in draws:
        cam = src["cameras"][view] if use_self_purification else (
            target["camera"])
        if purif_consistency_loss > 0:
            warps[cons].append((*_kc(src["cameras"][cons]), *_kc(cam)))
    src = dict(src, depths=np.stack([_clear_of_integers(d, warps[i]) for i, d
                                     in enumerate(_smooth_depths(n_src))]))
    cast = lambda d: {k: v.astype(np_dt) if v.dtype.kind == "f" else v
                      for k, v in d.items()}
    target, src, delta0 = cast(target), cast(src), delta0.astype(np_dt)
    with jax.enable_x64(f64):
        if f64:
            jb = dataclasses.replace(jb, params=jax.tree.map(
                lambda a: jnp.asarray(a, jnp.float64), jb.params))
        jsrc = {k: jnp.asarray(v) for k, v in src.items()}
        jtarget = {k: jnp.asarray(v) for k, v in target.items()}
        init, step = j_purify.make_purify_step(jb, jr, jcfg)
        jstate = init(jax.random.PRNGKey(0), jsrc["rgbs"],
                      jnp.asarray(delta0))
        purif0 = np.asarray(jstate["purif"])
        jauxs = []
        for key in keys:
            jstate, jaux = step(jstate, jtarget, jsrc, jnp.asarray(delta0),
                                key)
            jauxs.append({k: float(v) for k, v in jaux.items()})
        jstate = jax.tree.map(np.asarray, jstate)
    if f64:
        for m in (tb.feature_net, tb.net_coarse, tb.net_fine):
            if m is not None:
                m.double()
    tsrc = {k: _t(v) for k, v in src.items()}
    ttarget = {k: _t(v) for k, v in target.items()}
    init, step = t_purify.make_purify_step(tb, tr, tcfg)
    tstate = init(None, tsrc["rgbs"], _t(delta0), purif=_t(purif0, t_dt))
    tauxs = []
    for sel, view, cons in draws:
        tstate, taux = step(tstate, ttarget, tsrc, _t(delta0), sel=_t(sel),
                            view_id=view, cons_id=cons)
        tauxs.append({k: float(v) for k, v in taux.items()})
    return jstate, jauxs, tstate, tauxs, (tsrc["rgbs"] + _t(delta0), purif0)


@pytest.mark.parametrize("self_purif,cons", [(True, 0.0), (True, 0.1),
                                             (False, 0.1)],
                         ids=["self", "self_cons", "cons"])
def test_purify_step_matches_jax(monkeypatch, self_purif, cons):
    """One purification step of each objective (float32): loss and terms
    1e-4, the gradient by direction; purif stays in its eps-ball and the
    image box."""
    jstate, jauxs, tstate, tauxs, (base, _) = _purify_both(
        monkeypatch, False, 1, use_self_purification=self_purif,
        purif_consistency_loss=cons)
    names = {"loss"} | ({"rgb"} if self_purif else set()) | (
        {"camera_cons"} if cons else set())
    assert set(tauxs[0]) == names and tauxs[0]["loss"] > 0
    _check_terms(tauxs[0], jauxs[0], 1e-4)
    _check_direction(tstate["m"].numpy(), jstate["opt_state"][0].mu)
    purif = tstate["purif"]
    assert float(purif.abs().max()) <= 8.0 / 255.0 + 1e-7
    assert float((base + purif).min()) >= -1e-7
    assert float((base + purif).max()) <= 1 + 1e-7


def test_purify_trajectory_float64_matches_jax(monkeypatch):
    """Three purification steps, self-purification and the consistency
    term, with the step schedule (lr halved after 2), in float64 against JAX
    under x64, on tests/test_purify_x64.py's protocol: the first two losses
    and their terms 1e-6 (GNT's float32 positional encodings; that test
    holds 1e-7 and 1e-6 against the reference), the third 1e-5 (Adam's
    first steps move purif by lr at entries whose tiny gradient differs in
    sign, and the trajectories spread: 4.4e-6 measured), and the direction
    of purif's motion, cosine > 0.95 as there."""
    jstate, jauxs, tstate, tauxs, (_, purif0) = _purify_both(
        monkeypatch, True, 3)
    for t, j, tol in zip(tauxs, jauxs, (1e-6, 1e-6, 1e-5)):
        _check_terms(t, j, tol)
    assert len({round(a["loss"], 6) for a in tauxs}) == 3
    moved = (tstate["purif"].numpy() - purif0).ravel()
    ref = (jstate["purif"] - purif0).ravel()
    assert moved @ ref / np.linalg.norm(moved) / np.linalg.norm(ref) > 0.95
    assert np.abs(moved).max() > 1e-3
    assert tstate["step"] == 3


def test_noise_defense_matches_jax(monkeypatch):
    """``--def_random_noise``: delta plus a standard normal draw of the
    generator times std / 255, JAX's arithmetic on the same draw (1e-7)."""
    rng = np.random.RandomState(5)
    delta = ((rng.rand(3, 6, 7, 3) * 2 - 1) * 0.03).astype(np.float32)
    got = t_purify.apply_random_noise_defense(
        torch.Generator().manual_seed(4), _t(delta), 2.0)
    draw = torch.randn(delta.shape, generator=torch.Generator().manual_seed(4))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(draw.numpy()))
    ref = j_purify.apply_random_noise_defense(jax.random.PRNGKey(0),
                                              jnp.asarray(delta), 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-7)
    assert 0.5 * 2 / 255 < float((got - _t(delta)).std()) < 2 * 2 / 255
