"""How far the port's and JAX's float32 attack steps lie from a float64 run
of the same step: the measurement behind the loss parity tests
(``tests/test_torch_attack.py::test_every_loss_term_matches_jax``,
``tests/test_torch_universal.py::test_pcgrad_step_matches_jax``) and the
Adam steps' gradient direction (``test_adam_attack_step_matches_jax``).

    JAX_PLATFORMS=cpu python tests/parity_float64.py [--port-variant V]
    JAX_PLATFORMS=cpu python tests/parity_float64.py --clean-rows [--port-variant V]

The steps are those of the tests, with their seeds. The script runs itself
twice, in float32 and then with JAX's x64 and the port's modules in
float64 (x64 draws other random bits, so the float64 run takes the float32
run's ray indices), and prints per case and loss term |port - f64| / |f64|,
|JAX - f64| / |f64| and |port - JAX| / |JAX|, and the cosine between the
two packages' float32 gradients. GNT's float64 step renders other samples
than its float32 one, so for it only the cosine is printed.
``--clean-rows`` prints instead the port's and JAX's coarse PSNR and SSIM of
``test_global_source_clean_rows_match_jax_evaluator`` in float32.
``--port-variant`` changes the port's float32 arithmetic on the CPU for the
run: ``features_f64`` computes the feature net in float64 and rounds its
output, ``conv_f64`` its convolutions alone, ``native_conv`` takes
PyTorch's own convolution in place of oneDNN's.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
VARIANTS = ("none", "features_f64", "conv_f64", "native_conv")
CASES = {  # name: (backbone, n_importance, camera grads, pcgrad, AttackConfig)
    "every_loss": ("ibrnet", 8, False, False, dict(
        use_adam=True, adam_lr=1e-3, use_pseudo_gt=True, density_loss=0.5,
        depth_var_loss=0.1, depth_diff_loss=0.3, depth_smooth_loss=0.2,
        patch_size=4)),
    "pcgrad": ("ibrnet", 0, True, True, dict(
        use_adam=True, adam_lr=1e-3, use_pcgrad=True, depth_var_loss=0.1)),
    "adam_ibrnet": ("ibrnet", 0, False, False, dict(use_adam=True,
                                                    adam_lr=1e-3)),
    "adam_gnt": ("gnt", 0, False, False, dict(use_adam=True, adam_lr=1e-3)),
}


def _variant(name):
    import torch
    import torch.nn as nn
    if name == "native_conv":
        torch.backends.mkldnn.enabled = False
    elif name == "conv_f64":
        conv = nn.Conv2d._conv_forward

        def conv64(self, x, w, b):
            if x.dtype != torch.float32:
                return conv(self, x, w, b)
            return conv(self, x.double(), w.double(),
                        None if b is None else b.double()).float()
        nn.Conv2d._conv_forward = conv64
    elif name == "features_f64":
        from nerfool_tpu_torch.models.resunet import ResUNet
        forward = ResUNet.forward

        def forward64(self, x):
            if x.dtype != torch.float32:
                return forward(self, x)
            params = {k: v.double() for k, v in self.named_parameters()}
            out = torch.func.functional_call(self, params, (x.double(),))
            return tuple(None if o is None else o.float() for o in out)
        ResUNet.forward = forward64


def _steps(f64, sels):
    """Each case's step in both packages: {case: {"jax"|"port": {term:
    value, "m": Adam's first moment}}}, and the ray indices drawn."""
    import jax
    if f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch
    from nerfool_tpu.attack import attack as j_attack
    from nerfool_tpu_torch.attack import attack as t_attack
    from test_torch_attack import H, W, _render_cfgs, _scene
    np_dt = np.float64 if f64 else np.float32
    if f64:  # the port's rays in float64 (it builds them in float32)
        def rays_at(sel, w, intrinsics, c2w):
            u = (sel % w).to(intrinsics.dtype)
            v = torch.div(sel, w, rounding_mode="floor").to(intrinsics.dtype)
            pixels = torch.stack([u, v, torch.ones_like(u)], dim=0)
            d = (c2w[:3, :3] @ (torch.linalg.inv(intrinsics[:3, :3])
                                @ pixels)).T.contiguous()
            return c2w[:3, 3].expand_as(d), d
        t_attack.get_rays_at = rays_at
    out, drawn = {}, {}
    for name, (backbone, n_imp, cam_grad, pc, kw) in CASES.items():
        jb, tb, target, src, delta0 = _scene(np.random.RandomState(7),
                                             backbone)
        jr, tr = _render_cfgs(backbone, n_imp)
        if cam_grad:
            jr = dataclasses.replace(jr, stop_camera_grad=False)
            tr = dataclasses.replace(tr, stop_camera_grad=False)
        if f64:
            jb = dataclasses.replace(jb, params=jax.tree.map(
                lambda a: jnp.asarray(a, jnp.float64), jb.params))
            for m in (tb.feature_net, tb.net_coarse, tb.net_fine):
                if m is not None:
                    m.double()
        cast = lambda d: {k: v.astype(np_dt) if v.dtype.kind == "f" else v
                          for k, v in d.items()}
        target, src, delta0 = cast(target), cast(src), delta0.astype(np_dt)
        jcfg = j_attack.AttackConfig(h=H, w=W, n_rand=32, **kw)
        tcfg = t_attack.AttackConfig(h=H, w=W, n_rand=32, **kw)
        key = jax.random.PRNGKey(2)
        k_sel, k_render, k_pc = jax.random.split(key, 3)
        if sels:
            sel, sel_patch = (np.asarray(a) for a in sels[name])
            j_attack.select_ray_indices = lambda k, c, s=sel, p=sel_patch: (
                jnp.asarray(p if c.use_patch_sampling else s))
        else:
            sel = np.asarray(j_attack.select_ray_indices(k_sel, jcfg))
            sel_patch = np.asarray(j_attack.select_ray_indices(
                jax.random.fold_in(k_render, 23),
                dataclasses.replace(jcfg, use_patch_sampling=True)))
        drawn[name] = (sel.tolist(), sel_patch.tolist())
        jsrc = {k: jnp.asarray(v) for k, v in src.items()}
        jsrc["featmaps_clean"] = jb.extract_features(jsrc["rgbs"])
        jstate = dict(j_attack.init_attack_state(
            jax.random.PRNGKey(1), jcfg, jsrc["rgbs"]),
            delta=jnp.asarray(delta0))
        jstate, jaux = jax.jit(j_attack.make_attack_step(jb, jr, jcfg))(
            jstate, {k: jnp.asarray(v) for k, v in target.items()}, jsrc, key)
        tsrc = {k: torch.as_tensor(v) for k, v in src.items()}
        with torch.no_grad():
            tsrc["featmaps_clean"] = tb.extract_features(tsrc["rgbs"])
        tstate = t_attack.init_attack_state(None, tcfg, tsrc["rgbs"],
                                            delta=torch.as_tensor(delta0))
        extra = (dict(pc_order=np.asarray(jax.random.permutation(
            k_pc, len(jcfg.enabled_losses())))) if pc else
            dict(sel_patch=torch.as_tensor(sel_patch)))
        tstate, taux = t_attack.make_attack_step(tb, tr, tcfg)(
            tstate, {k: torch.as_tensor(v) for k, v in target.items()}, tsrc,
            sel=torch.as_tensor(sel), **extra)
        out[name] = {
            "jax": {**{k: float(v) for k, v in jaux.items()},
                    "m": np.asarray(jstate["opt_state"][0].mu[0]).tolist()},
            "port": {**{k: float(v) for k, v in taux.items()},
                     "m": tstate["m"].double().numpy().tolist()}}
    return out, drawn


def _clean_rows():
    import jax
    import torch
    import test_torch_universal as T
    tmp = pathlib.Path(tempfile.mkdtemp())
    jb = T.j_create_model(backbone="ibrnet", rng_key=jax.random.PRNGKey(0))
    ckpt = tmp / "model.pth"
    torch.save(T.params_from_flax(jax.tree.map(np.asarray, jb.params)), ckpt)
    args = T._engine_args(tmp, no_attack=True, use_center_view=True)
    ref = T.AdvEvaluator(args, bundle=jb, dataset_kwargs=T.TINY).evaluate(
        verbose=False, save_images=False)["synthetic"]
    out = T.port_eval_adv.main(T._argv(
        tmp, "--no_attack", "--use_center_view", "--ckpt_path",
        str(ckpt)))["synthetic"]
    for k in sorted(v for v in ref if v.startswith("synthetic_")):
        print(f"{k}: coarse PSNR port {out[k]['coarse_psnr']:.6f} JAX "
              f"{ref[k]['coarse_psnr']:.6f}; coarse SSIM port "
              f"{out[k]['coarse_ssim']:.8f} JAX {ref[k]['coarse_ssim']:.8f}, "
              f"difference {out[k]['coarse_ssim'] - ref[k]['coarse_ssim']:.4g}")


def _child(mode, variant, sels_path, out_path):
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import torch
    torch.set_num_threads(2)
    _variant(variant)
    if mode == "clean_rows":
        return _clean_rows()
    sels = json.load(open(sels_path)) if mode == "f64" else None
    out, drawn = _steps(mode == "f64", sels)
    json.dump(dict(out=out, drawn=drawn), open(out_path, "w"))


def main():
    args = sys.argv[1:]
    if args and args[0] == "--child":
        return _child(*args[1:])
    variant = args[args.index("--port-variant") + 1] if (
        "--port-variant" in args) else "none"
    if variant not in VARIANTS:
        raise SystemExit(f"--port-variant: one of {VARIANTS}")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = lambda *a: subprocess.run([sys.executable, __file__, "--child",
                                     *a], env=env, check=True)
    if "--clean-rows" in args:
        return run("clean_rows", variant, "", "")
    with tempfile.TemporaryDirectory() as tmp:
        f32, f64 = (os.path.join(tmp, n) for n in ("f32.json", "f64.json"))
        run("f32", variant, "", f32)
        lo = json.load(open(f32))
        with open(os.path.join(tmp, "sels.json"), "w") as f:
            json.dump(lo["drawn"], f)
        run("f64", "none", os.path.join(tmp, "sels.json"), f64)
        hi = json.load(open(f64))["out"]
    print(f"port variant: {variant}")
    for name, r in lo["out"].items():
        p, j = np.array(r["port"]["m"]), np.array(r["jax"]["m"])
        cos = float(p.ravel() @ j.ravel() / np.linalg.norm(p)
                    / np.linalg.norm(j))
        print(f"{name}: gradient cosine port-JAX {cos:.6f}")
        for term in (t for t in r["jax"] if t != "m"):
            pv, jv = r["port"][term], r["jax"][term]
            line = f"  {term}: |port - JAX| / |JAX| {abs(pv - jv) / abs(jv):.3e}"
            if CASES[name][0] != "gnt":
                t, tj = hi[name]["port"][term], hi[name]["jax"][term]
                line += (f", from float64: port {abs(pv - t) / abs(t):.3e}, "
                         f"JAX {abs(jv - t) / abs(t):.3e} (the two float64 "
                         f"runs {abs(t - tj) / abs(tj):.1e} apart)")
            print(line)


if __name__ == "__main__":
    main()
