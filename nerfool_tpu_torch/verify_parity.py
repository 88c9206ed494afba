"""Real-data parity runbook on the port (the counterpart of the JAX
package's ``verify_parity`` script): runs the flagship NeRFool workloads
through the original NeRFool code, as an oracle, and through the port's
``python -m nerfool_tpu_torch.eval_adv``, and prints a side-by-side table of
clean and attacked PSNR / SSIM / LPIPS with the +/-0.2 dB / 0.005 SSIM
verdict.

    python -m nerfool_tpu_torch.verify_parity [--backbone ibrnet|gnt] \\
        [--data_dir data/nerf_llff_data --ckpt model_255000.pth \\
         --scene fern] \\
        [--fixture] [--runs clean,view_specific,universal] \\
        --reference <NeRFool checkout> [--device cuda] [--lpips_weights lpips.npz]

Two modes:

* real (``--data_dir`` holding ``<scene>/`` and ``--ckpt``, the published
  ``model_255000.pth`` / ``model_720000.pth``): the reference's flagship
  shapes (``--adv_iters 1000 --epsilon 8 --use_adam --adam_lr 1e-3
  --adv_lr 1 --lr_gamma 1 --num_source_views 4``).
* ``--fixture`` (the default when the real data or checkpoint is absent):
  ``make_fixture`` writes a tiny LLFF-format scene and a random checkpoint
  in the reference's layout, from the port's own modules, and both stacks
  run on it.

The oracle is a checkout of the original NeRFool at ``--reference`` (a
required argument), driven in a subprocess with stubs for the packages it imports but does not need, CUDA
calls mapped to the CPU where there is no card, and its LPIPS reading NaN
without its frozen graph. Without that checkout the runbook exits non-zero
and names the path: one column is no comparison.

Clean metrics must agree within the tolerances (same arithmetic, same
checkpoint); attacked rows are reported against the same target but marked
seed-sensitive (the two stacks draw delta and the rays from other random
streams).
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_results(path):
    """Both sides dump str(dict); tolerate numpy scalar reprs and nan/inf."""
    with open(path) as f:
        text = f.read()
    text = re.sub(r"np\.float\d+\(([^)]*)\)", r"\1", text)
    text = re.sub(r"float\d+\(([^)]*)\)", r"\1", text)
    return eval(text, {"__builtins__": {}},
                {"nan": float("nan"), "inf": float("inf")})


# the oracle's runner: runs the reference evaluator in a subprocess with the
# stubs and patches it needs off the reference's own environment
REF_DRIVER = r"""
import argparse, os, sys, types
REF, STACK = sys.argv[1], sys.argv[2]


class _ConfigArgumentParser(argparse.ArgumentParser):
    def add_argument(self, *args, **kwargs):
        kwargs.pop('is_config_file', None)
        return super().add_argument(*args, **kwargs)


def _stub(name, **attrs):
    if name not in sys.modules:
        m = types.ModuleType(name)
        m.__dict__.update(attrs)
        sys.modules[name] = m
    return sys.modules[name]


_stub('configargparse', ArgumentParser=_ConfigArgumentParser)
_stub('tensorboardX', SummaryWriter=object)
if 'torchvision' not in sys.modules:
    def _any_transform(name):
        if name.startswith('__'):
            raise AttributeError(name)
        return object
    tr = _stub('torchvision.transforms', __getattr__=_any_transform)
    _stub('torchvision', transforms=tr)


class _LPIPS:
    # eval/gnt/utils.py builds lpips.LPIPS when it is imported
    def __init__(self, *a, **k):
        pass

    def cuda(self, *a, **k):
        return self


_stub('lpips', LPIPS=_LPIPS)
sys.path.insert(0, REF)
sys.path.insert(0, os.path.join(REF, 'eval', STACK))
import torch
if not torch.cuda.is_available():
    torch.Tensor.cuda = lambda self, *a, **k: self
    torch.nn.Module.cuda = lambda self, *a, **k: self
    def _remap(a, k):
        a = tuple('cpu' if isinstance(x, (str, torch.device)) and 'cuda' in str(x)
                  else x for x in a)
        if k.get('device') is not None and 'cuda' in str(k['device']):
            k = dict(k, device='cpu')
        return a, k
    _tto = torch.Tensor.to
    def _tensor_to(self, *a, **k):
        a, k = _remap(a, k)
        return _tto(self, *a, **k)
    torch.Tensor.to = _tensor_to
    _mto = torch.nn.Module.to
    def _module_to(self, *a, **k):
        a, k = _remap(a, k)
        return _mto(self, *a, **k)
    torch.nn.Module.to = _module_to
if STACK == 'ibrnet':
    import tensorflow as tf
    from lpips_tensorflow import lpips_tf
    cache = os.path.expanduser('~/.lpips')
    have_pb = os.path.isdir(cache) and any(
        f.startswith('net-lin_vgg') and f.endswith('.pb') for f in os.listdir(cache))
    if not have_pb:
        lpips_tf.lpips = (lambda a, b, **k:
                          float('nan') + 0.0 * tf.reduce_sum(a, axis=[-3, -2, -1]))
else:
    # LPIPS reads NaN on the GNT stack without its weights
    sys.modules['lpips'].LPIPS.__call__ = (
        lambda self, *a, **k: torch.tensor(float('nan')))
import numpy as np, imageio
_imw = imageio.imwrite
def _compat_imwrite(uri, im, *a, **k):
    im = np.asarray(im)
    if im.dtype.kind == 'f':
        im = (255 * np.clip(im, 0, 1)).astype('uint8')
    return _imw(uri, im, *a, **k)
imageio.imwrite = _compat_imwrite
sys.argv = ['eval_adv.py'] + sys.argv[3:]
import runpy
runpy.run_path(os.path.join(REF, 'eval', STACK, 'eval_adv.py'),
               run_name='__main__')
"""


def _smooth_image(rng, h, w):
    """Box-blurred noise scaled to [0, 255], so that renders carry
    structure."""
    from numpy.lib.stride_tricks import sliding_window_view

    img = rng.rand(h + 8, w + 8, 3)
    img = np.einsum("hwcij,ij->hwc",
                    sliding_window_view(img, (9, 9), axis=(0, 1)),
                    np.ones((9, 9)) / 81.0)
    img = (img - img.min()) / (np.ptp(img) + 1e-9)
    return (img * 255).astype(np.uint8)


def make_fixture(workdir, backbone, h=40, w=48, n=10):
    """A tiny LLFF-format scene ``fixscene`` of ``n`` views at ``h`` x
    ``w`` and a random checkpoint in the reference's layout, written from
    the port's own modules' state dicts (``torch.save``).

    The reference's GNT loader reads ``images_4/`` at a fixed factor 4, so
    for GNT the working frames go to ``images_4/`` and a nearest-upscaled
    copy to ``images/`` with the focal scaled by 4; both stacks then read
    ``images_4`` at factor 4.

    :return: (scene directory, checkpoint path)
    """
    import torch

    from nerfool_tpu_torch.models.bundle import create_model
    from nerfool_tpu_torch.utils.vis import write_png

    factor = 4 if backbone == "gnt" else 1
    scene_dir = os.path.join(workdir, "data", "nerf_llff_data", "fixscene")
    # the reference parses the step from the name's last six digits
    ckpt = os.path.join(workdir, "pretrained", backbone, "model_000001.pth")
    if not os.path.isdir(scene_dir):
        os.makedirs(os.path.join(scene_dir, "images"))
        if factor != 1:
            os.makedirs(os.path.join(scene_dir, f"images_{factor}"))
        rng = np.random.RandomState(0)
        poses = []
        for i in range(n):
            img8 = _smooth_image(rng, h, w)
            name = f"im{i:03d}.png"
            if factor == 1:
                write_png(os.path.join(scene_dir, "images", name), img8)
            else:
                write_png(os.path.join(scene_dir, f"images_{factor}", name),
                          img8)
                up = np.repeat(np.repeat(img8, factor, 0), factor, 1)
                write_png(os.path.join(scene_dir, "images", name), up)
            # the LLFF pose convention [down right back] and an hwf column
            theta = (i / n - 0.5) * 0.4
            c2w = np.eye(4)
            c2w[:3, 3] = [np.sin(theta) * 2, 0.1 * np.sin(i),
                          -0.2 * np.cos(theta)]
            hwf = np.array([[h * factor], [w * factor], [60.0 * factor]])
            poses.append(np.concatenate([c2w[:3, :4], hwf], 1).reshape(-1))
        bounds = np.stack([np.full(n, 2.0), np.full(n, 12.0)], -1)
        np.save(os.path.join(scene_dir, "poses_bounds.npy"),
                np.concatenate([np.stack(poses), bounds], axis=1))
    if not os.path.isfile(ckpt):
        os.makedirs(os.path.dirname(ckpt), exist_ok=True)
        bundle = create_model(backbone=backbone, seed=7, netwidth=64,
                              trans_depth=2, single_net=True, ret_alpha=True)
        nets = {"feature_net": bundle.feature_net,
                "net_coarse": bundle.net_coarse}
        if bundle.net_fine is not None:
            nets["net_fine"] = bundle.net_fine
        torch.save({k: m.state_dict() for k, m in nets.items()}, ckpt)
    return scene_dir, ckpt


def fixture_settings(a):
    """The fixture run's shapes on the namespace ``a``."""
    a.scene = "fixscene"
    a.rootdir = a.workdir
    a.N_samples, a.N_importance, a.inv_uniform = 8, 8, True
    if a.backbone == "gnt":
        a.N_importance = 0
    a.chunk_size, a.N_rand, a.trans_depth = 512, 64, 2
    a.num_source_views = 4
    # GNT: the reference always loads at factor 4 (see make_fixture)
    a.llff_factor = 4 if a.backbone == "gnt" else 1
    a.adv_iters = a.adv_iters or 6
    return a


def build_flags(a, run, ckpt):
    """One flag list for both parsers (the same flag surface)."""
    flags = [
        "--rootdir", a.rootdir,
        "--ckpt_path", ckpt,
        "--expname", f"parity_{run}",
        "--eval_dataset", "llff_test",
        "--eval_scenes", a.scene,
        "--num_source_views", str(a.num_source_views),
        "--N_samples", str(a.N_samples),
        "--N_importance", str(a.N_importance),
        "--N_rand", str(a.N_rand),
        "--chunk_size", str(a.chunk_size),
        "--llff_factor", str(a.llff_factor),
        "--adv_iters", str(a.adv_iters),
        "--epsilon", "8", "--adv_lr", "1",
        "--use_adam", "--adam_lr", "1e-3", "--lr_gamma", "1",
        "--workers", "0",
        # eval checkpoints carry no optimizer or scheduler state; the
        # reference GNT evaluator loads both unless told not to
        "--no_load_opt", "--no_load_scheduler",
    ]
    if a.inv_uniform:
        flags.append("--inv_uniform")
    if a.backbone == "gnt":
        flags += ["--trans_depth", str(a.trans_depth), "--netwidth", "64",
                  "--single_net", "True", "--ret_alpha"]
    if run == "clean":
        flags += ["--no_attack", "--view_specific"]
    elif run == "view_specific":
        flags += ["--view_specific"]
    # run == 'universal': neither flag
    return flags


def metrics_of(scene_results, level):
    """{'psnr', 'ssim', 'lpips'} of one level's means."""
    return {m: scene_results[f"{level}_mean_{m}"]
            for m in ("psnr", "ssim", "lpips")}


def run_reference(a, flags, run):
    """The oracle's metrics of one run."""
    env = dict(os.environ)
    env.setdefault("CUDA_VISIBLE_DEVICES", "")
    cwd = os.path.join(a.workdir, "ref")
    os.makedirs(cwd, exist_ok=True)
    if a.backbone == "gnt":
        # the reference GNT parser has no --llff_factor (its loader fixes 4)
        i = flags.index("--llff_factor")
        flags = flags[:i] + flags[i + 2:]
    cmd = [sys.executable, "-c", REF_DRIVER, a.reference, a.backbone, *flags]
    print(f"[reference/{run}] {' '.join(cmd[-12:])}")
    res = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=a.timeout)
    if res.returncode != 0:
        print(res.stdout[-3000:], res.stderr[-3000:])
        raise RuntimeError(f"reference {run} run failed")
    if a.backbone == "ibrnet":
        out = os.path.join(cwd, "llff_test", f"parity_{run}")
        fn = [f for f in os.listdir(out) if f.startswith(f"psnr_{a.scene}")]
        s = parse_results(os.path.join(out, fn[0]))[a.scene]
        return metrics_of(s, "fine")
    d = parse_results(os.path.join(a.rootdir, "out", f"parity_{run}",
                                   "results.txt"))
    return {"psnr": d["avg_psnr"], "ssim": d["avg_ssim"],
            "lpips": d["avg_lpips"]}


def run_ours(a, flags, run):
    """The port's results of one run (``python -m
    nerfool_tpu_torch.eval_adv`` on ``a.device``): the scene's dict."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    cwd = os.path.join(a.workdir, "ours")
    os.makedirs(cwd, exist_ok=True)
    cmd = [sys.executable, "-m", "nerfool_tpu_torch.eval_adv", "--backbone",
           a.backbone, *flags, "--device", a.device]
    if a.lpips_weights:
        cmd += ["--lpips_weights", os.path.abspath(a.lpips_weights)]
    print(f"[ours/{run}] {' '.join(cmd[-12:])}")
    res = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=a.timeout)
    if res.returncode != 0:
        print(res.stdout[-3000:], res.stderr[-3000:])
        raise RuntimeError(f"our {run} run failed")
    out = os.path.join(cwd, "llff_test", f"parity_{run}", a.scene)
    return parse_results(os.path.join(out, f"psnr_{a.scene}.txt"))[a.scene]


def verdict(rows, tol_psnr=0.2, tol_ssim=0.005):
    """The parity table of ``rows`` [(run, reference metrics, our
    metrics)]: (lines, ok), ok when every clean PSNR and SSIM lies within
    its tolerance. Attacked rows outside it read SEED-SENSITIVE, LPIPS is
    reported only (n/a where either side is NaN)."""
    lines = [f"{'run':>14} | {'metric':>6} | {'reference':>10} | "
             f"{'ours':>10} | {'delta':>8} | verdict"]
    ok = True
    for run, ref, ours in rows:
        for m, tol in (("psnr", tol_psnr), ("ssim", tol_ssim),
                       ("lpips", None)):
            d = ours[m] - ref[m]
            if tol is None or d != d:
                mark = "n/a" if d != d else "report-only"
            else:
                attacked = run != "clean"
                passed = abs(d) <= tol
                mark = ("PASS" if passed else
                        ("SEED-SENSITIVE" if attacked else "FAIL"))
                ok = ok and (passed or attacked)
            lines.append(f"{run:>14} | {m:>6} | {ref[m]:>10.4f} | "
                         f"{ours[m]:>10.4f} | {d:>+8.4f} | {mark}")
    lines.append("VERDICT: " + ("PASS (clean parity within tolerance)" if ok
                                else "FAIL (clean metrics drift beyond "
                                "tolerance)"))
    return lines, ok


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--backbone", default="ibrnet", choices=["ibrnet", "gnt"])
    p.add_argument("--scene", default="fern")
    p.add_argument("--data_dir", default="data/nerf_llff_data",
                   help="LLFF data root (containing <scene>/)")
    p.add_argument("--ckpt", default="",
                   help="reference .pth (model_255000.pth / model_720000.pth)")
    p.add_argument("--fixture", action="store_true",
                   help="force the generated-fixture dry-run")
    p.add_argument("--runs", default="clean,view_specific",
                   help="comma list of clean,view_specific,universal")
    p.add_argument("--workdir", default="out/verify_parity")
    p.add_argument("--reference", required=True,
                   help="checkout of the original NeRFool (the oracle)")
    p.add_argument("--device", default="cuda",
                   help="our side's device (cuda or cpu)")
    p.add_argument("--adv_iters", type=int, default=None)
    p.add_argument("--lpips_weights", default="",
                   help=".npz from python -m nerfool_tpu_torch."
                        "export_lpips_weights (our side; the reference side "
                        "uses its ~/.lpips .pb cache)")
    p.add_argument("--tol_psnr", type=float, default=0.2)
    p.add_argument("--tol_ssim", type=float, default=0.005)
    p.add_argument("--timeout", type=int, default=24 * 3600)
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    if not os.path.isdir(a.reference):
        sys.exit(f"verify_parity: no reference checkout at {a.reference}: "
                 "the runbook needs the original NeRFool "
                 "as its oracle and reports nothing without it")
    have_real = (not a.fixture and a.ckpt and os.path.isfile(a.ckpt)
                 and os.path.isdir(os.path.join(a.data_dir, a.scene)))
    a.workdir = os.path.abspath(a.workdir)
    os.makedirs(a.workdir, exist_ok=True)
    if have_real:
        a.rootdir = os.path.abspath(os.path.join(a.data_dir, "..", ".."))
        ckpt = os.path.abspath(a.ckpt)
        # the flagship shapes (configs/ibrnet/eval_llff.txt, gnt_full.txt)
        if a.backbone == "ibrnet":
            a.N_samples, a.N_importance, a.inv_uniform = 64, 64, True
            a.chunk_size, a.N_rand, a.trans_depth = 4096, 512, 8
        else:
            a.N_samples, a.N_importance, a.inv_uniform = 192, 0, True
            a.chunk_size, a.N_rand, a.trans_depth = 800, 800, 8
        a.num_source_views, a.llff_factor = 4, 4
        a.adv_iters = a.adv_iters or 1000
    else:
        print("== fixture dry-run (no real data/checkpoint found) ==")
        _, ckpt = make_fixture(a.workdir, a.backbone)
        fixture_settings(a)

    level = "fine" if a.backbone == "ibrnet" else "coarse"
    rows = []
    for run in a.runs.split(","):
        flags = build_flags(a, run, ckpt)
        ref = run_reference(a, flags, run)
        ours = metrics_of(run_ours(a, flags, run), level)
        rows.append((run, ref, ours))
    print(f"\n== parity table ({a.backbone}/{a.scene}, "
          f"{'REAL' if have_real else 'FIXTURE'}, adv_iters={a.adv_iters}) ==")
    lines, ok = verdict(rows, a.tol_psnr, a.tol_ssim)
    print("\n".join(lines))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
