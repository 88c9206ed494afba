"""Adversarial and clean whole-frame evaluator (port of the view-specific
paths of ``nerfool_tpu/attack/engine.py`` ``AdvEvaluator``): per test view,
optionally ``adv_iters`` attack iterations on the perturbation ``delta`` of
the view's own source images (``attack/attack.py``), then the whole-frame
render with IBRNet or GNT from the perturbed sources, measured with PSNR and
SSIM in the backbone's protocol (TF's for IBRNet, ``img2psnr`` and windowed
SSIM for GNT). LPIPS is not ported and reads NaN.

The attack runs in float32 on the per-tap gather. ``--gnt_fused_attack``
routes the differentiated GNT step through the ray-attention kernel
(``ops/ray_attention.py``, forward and backward), ``--gnt_fused_attn on``
the no-grad f32 GNT renders; on the CPU both take the kernel's plain
version. Not ported, raising ``NotImplementedError`` by flag name: the
universal attack (no ``--view_specific``), the global source set, unseen-view
targets, hybrid clean-feature renders, purification, the noise defense, and
the attack options ``make_attack_step`` lists.

GNT renders in float32 or bfloat16 (``--compute_dtype``); IBRNet in float32
only. ``--gnt_fused_chain`` resolves as in the JAX evaluator: ``auto`` runs
bf16 whole-frame GNT renders on a CUDA device through the whole-chain kernel
(``ops/chain.py``), ``on`` forces the chain (its plain version on the CPU),
``off`` keeps the module path. f32 renders take the module path either way.

Whole-frame renders take the block segment-patch gather by default
(``--use_bspg``): it is planned once over every camera the dataset can emit,
with one uniform worst-case slot budget across the ``n_src`` source slots,
so one plan serves every view. Planning that fails raises; it never drops to
the per-tap gather (``--use_bspg False`` asks for that route).
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings

import numpy as np
import torch

from nerfool_tpu_torch.attack.attack import (
    AttackConfig,
    init_attack_state,
    make_attack_step,
)
from nerfool_tpu_torch.data import dataset_dict
from nerfool_tpu_torch.device import resolve_device
from nerfool_tpu_torch.metrics.image import img2psnr, psnr, ssim, ssim_windowed
from nerfool_tpu_torch.models.bundle import create_model
from nerfool_tpu_torch.models.resunet import feature_hw
from nerfool_tpu_torch.render.render_image import render_single_image
from nerfool_tpu_torch.render.render_rays import RenderConfig
from nerfool_tpu_torch.utils.cameras import get_rays


def render_config_from_args(args) -> RenderConfig:
    if args.backbone not in ("ibrnet", "gnt"):
        raise ValueError(f"unknown backbone {args.backbone!r}")
    if args.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"--compute_dtype {args.compute_dtype} (float32 or "
                         "bfloat16)")
    gnt = args.backbone == "gnt"
    if args.compute_dtype != "float32" and not gnt:
        raise ValueError("the port renders IBRNet in float32 only "
                         f"(--compute_dtype {args.compute_dtype})")
    return RenderConfig(n_samples=args.N_samples,
                        n_importance=args.N_importance,
                        inv_uniform=bool(args.inv_uniform),
                        white_bkgd=bool(args.white_bkgd),
                        backbone=args.backbone,
                        single_net=gnt and bool(args.single_net),
                        ret_alpha=not gnt or bool(args.ret_alpha),
                        compute_dtype=args.compute_dtype)


def build_attack_config(args, h, w) -> AttackConfig:
    return AttackConfig(
        h=h, w=w,
        epsilon=float(args.epsilon), adv_lr=args.adv_lr,
        adv_iters=args.adv_iters, use_adam=args.use_adam,
        adam_lr=args.adam_lr, lr_step_size=args.lr_step_size,
        lr_gamma=args.lr_gamma, n_rand=args.N_rand,
        sample_mode=args.sample_mode, center_ratio=args.center_ratio,
        use_patch_sampling=args.use_patch_sampling,
        patch_size=args.patch_size, use_pseudo_gt=args.use_pseudo_gt,
        density_loss=args.density_loss, depth_var_loss=args.depth_var_loss,
        depth_diff_loss=args.depth_diff_loss,
        depth_smooth_loss=args.depth_smooth_loss,
        depth_consistency_loss=args.depth_consistency_loss,
        ds_rgb=args.ds_rgb,
        camera_consistency_loss=args.camera_consistency_loss,
        use_pcgrad=args.use_pcgrad, perturb_camera=args.perturb_camera,
        perturb_camera_no_opt=args.perturb_camera_no_opt)


# flags of parts that are not ported: (flag, applies to clean runs too)
_UNPORTED_FLAGS = (("use_unseen_views", False), ("use_clean_color", True),
                   ("use_clean_density", True), ("use_purification", False),
                   ("def_random_noise", False), ("geo_noise", False))


class Evaluator:
    def __init__(self, args, bundle=None, dataset_kwargs=None, device="cuda",
                 seed=0):
        args.det = True  # the reference forces deterministic sampling
        self.args = args
        self.device = resolve_device(device)
        self.render_cfg = render_config_from_args(args)
        self.bundle = bundle if bundle is not None else create_model(
            args=args, seed=seed, device=self.device)
        self.test_dataset = dataset_dict[args.eval_dataset](
            args, "test", scenes=args.eval_scenes, **(dataset_kwargs or {}))
        self._bspg_specs = {}  # n_src -> (spec_feat, spec_rgb)
        self._bspg_hw = None
        # the attack's random draws (delta's init, the ray subsets)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        self.last_attack = None  # losses and seconds of the newest attack

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _make_target(self, data):
        cam = np.asarray(data["camera"]).reshape(-1)[:34]
        opt = lambda k, shape: (self._tensor(data[k]).reshape(shape)
                                if data.get(k) is not None else None)
        target = {"camera": self._tensor(cam), "rgb": opt("rgb", (-1, 3)),
                  "depth": opt("depth", (-1,)),
                  "depth_range": self._tensor(data["depth_range"]).reshape(1, 2)}
        return target, (int(cam[0]), int(cam[1]))

    def _make_src(self, data, clean_feats=False):
        """The view's source set on the device; ``clean_feats`` adds the
        features of the clean sources (the attack's pseudo ground truth)."""
        src = {"rgbs": self._tensor(data["src_rgbs"]),
               "cameras": self._tensor(data["src_cameras"]).reshape(-1, 34),
               "featmaps_clean": None}
        if clean_feats:
            with torch.no_grad():
                src["featmaps_clean"] = self.bundle.extract_features(
                    src["rgbs"])
        return src

    def _fused_chain(self):
        """``--gnt_fused_chain`` for whole-frame renders: auto = on a CUDA
        device."""
        mode = getattr(self.args, "gnt_fused_chain", "auto")
        return self.args.backbone == "gnt" and (
            mode == "on" or (mode == "auto" and self.device.type == "cuda"))

    def view_render_cfg(self, n_src):
        """Render config for whole-frame renders with ``n_src`` source views;
        plans BSPG on first use (numpy, host)."""
        args = self.args
        base = dataclasses.replace(
            self.render_cfg, gnt_fused_chain=self._fused_chain(),
            gnt_fused_attn=(args.backbone == "gnt" and getattr(
                args, "gnt_fused_attn", "auto") == "on"))
        if not getattr(args, "use_bspg", True):
            return base
        if n_src in self._bspg_specs:
            return dataclasses.replace(base,
                                       bspg_specs=self._bspg_specs[n_src])
        from nerfool_tpu_torch.ops.bspg import plan_render_specs

        fn = getattr(self.test_dataset, "target_cameras", None)
        got = fn() if fn is not None else None
        if got is None:
            raise RuntimeError(
                f"BSPG cannot be planned: {type(self.test_dataset).__name__} "
                "exposes no target_cameras(); pass --use_bspg False for the "
                "per-tap route")
        cams_all = np.asarray(got[0], np.float64)
        dr = np.asarray(got[1], np.float64)
        h, w = int(cams_all[0][0]), int(cams_all[0][1])
        blk = int(getattr(args, "bspg_block", 8))
        specs = plan_render_specs(cams_all, cams_all, dr, (h, w),
                                  feature_hw(h, w), block=(blk, blk),
                                  render_stride=args.render_stride)
        if specs is None:
            raise RuntimeError(
                "BSPG planning failed: no admissible patch size covers the "
                "epipolar spans of this camera set; pass --use_bspg False for "
                "the per-tap route")
        # any candidate camera may fill any of the n_src slots: one group with
        # the worst-case crossing budget
        specs = tuple(
            dataclasses.replace(
                sp, groups=((tuple(range(n_src)), max(k for _, k in sp.groups)),))
            for sp in specs)
        self._bspg_hw = (h, w)
        self._bspg_specs[n_src] = specs
        return dataclasses.replace(base, bspg_specs=specs)

    def adopt_plan(self, other):
        """Take over ``other``'s BSPG plans instead of planning again. A
        plan depends on the cameras, the frame, the ray block and the render
        stride, not on the backbone's dtype or weights: both evaluators must
        agree on those."""
        mine, theirs = self.args, other.args
        same = (type(self.test_dataset) is type(other.test_dataset)
                and all(getattr(mine, k) == getattr(theirs, k) for k in (
                    "render_stride", "bspg_block", "eval_dataset",
                    "eval_scenes", "num_source_views")))
        fn = getattr(self.test_dataset, "target_cameras", None)
        if same and fn is not None:
            a, b = fn(), other.test_dataset.target_cameras()
            same = all(np.array_equal(np.asarray(x), np.asarray(y))
                       for x, y in zip(a, b))
        if not same:
            raise ValueError("the evaluators differ in camera set, frame, "
                             "ray block or render stride")
        self._bspg_specs = dict(other._bspg_specs)
        self._bspg_hw = other._bspg_hw

    def _grad_render_cfg(self):
        """Render config of the differentiated attack step: float32, and
        with ``--gnt_fused_attack`` GNT's ray attention through the fused
        kernel (its plain version on the CPU)."""
        args = self.args
        if args.compute_dtype != "float32":
            raise ValueError("the attack runs in float32 "
                             f"(--compute_dtype {args.compute_dtype})")
        return dataclasses.replace(
            self.render_cfg, gnt_fused_attn=(
                args.backbone == "gnt"
                and bool(getattr(args, "gnt_fused_attack", False))))

    def attack_view_specific(self, data, verbose=False, delta=None):
        """Optimize ``delta`` against one test view's own source set for
        ``args.adv_iters`` iterations. ``delta``: the start (drawn from the
        evaluator's generator when None). Returns (delta, src,
        src_cameras); ``last_attack`` keeps the per-iteration losses and the
        host seconds of the loop, ending in a device synchronize."""
        args = self.args
        target, (h, w) = self._make_target(data)
        cfg = build_attack_config(args, h, w)
        step = make_attack_step(self.bundle, self._grad_render_cfg(), cfg)
        src = self._make_src(data, clean_feats=cfg.use_pseudo_gt)
        state = init_attack_state(self.generator, cfg, src["rgbs"], delta)
        n_iters = args.adv_iters
        every = max(1, n_iters // 10)
        losses = []
        self._sync()
        t0 = time.perf_counter()
        for i in range(n_iters):
            state, aux = step(state, target, src, generator=self.generator)
            losses.append(aux["loss"])
            if verbose and ((i + 1) % every == 0 or i + 1 == n_iters):
                print(f"  attack iter {i + 1}/{n_iters} "
                      f"loss={float(aux['loss']):.5f} "
                      f"({(time.perf_counter() - t0) / (i + 1) * 1e3:.0f} "
                      "ms/iter)", flush=True)
        self._sync()
        self.last_attack = {
            "seconds": time.perf_counter() - t0, "iters": n_iters,
            "losses": (torch.stack(losses).cpu() if losses
                       else torch.zeros(0))}
        return self._finalize(state, src)

    def _finalize(self, state, src):
        for name in ("use_purification", "def_random_noise"):
            if getattr(self.args, name, 0):
                raise NotImplementedError(
                    f"not ported to nerfool_tpu_torch: --{name}")
        return state["delta"], src, src["cameras"]

    def render_view(self, data, src, delta=None, src_cameras=None):
        """Whole-frame render of one test view from its source views, whose
        features come from ``src + delta`` when a perturbation is given (the
        RGB taps stay clean, as in the attack step)."""
        args = self.args
        if src_cameras is None:
            src_cameras = src["cameras"]
        cam = np.asarray(data["camera"]).reshape(-1)[:34]
        h, w = int(cam[0]), int(cam[1])
        cam_t = self._tensor(cam)
        rays_o, rays_d = get_rays(h, w, cam_t[2:18].reshape(4, 4),
                                  cam_t[18:34].reshape(4, 4),
                                  render_stride=args.render_stride)
        batch = {
            "ray_o": rays_o, "ray_d": rays_d,
            "depth_range": self._tensor(data["depth_range"]).reshape(1, 2),
            "camera": cam_t[None],
        }
        feats = self.bundle.extract_features(
            src["rgbs"] if delta is None else src["rgbs"] + delta)
        rcfg = self.view_render_cfg(int(src_cameras.shape[0]))
        if rcfg.bspg_specs is not None and self._bspg_hw != (h, w):
            raise ValueError(f"BSPG plan covers {self._bspg_hw} frames, "
                             f"not {(h, w)}")
        return render_single_image(
            self.bundle.nets, batch, feats, rcfg, h, w, src["rgbs"],
            src_cameras, chunk_size=args.chunk_size,
            render_stride=args.render_stride)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _check_ported(self):
        args = self.args
        if not args.view_specific:
            raise NotImplementedError(
                "not ported to nerfool_tpu_torch: the universal attack and "
                "the global source set (pass --view_specific)")
        bad = [name for name, clean_too in _UNPORTED_FLAGS
               if getattr(args, name, 0) and (clean_too or not args.no_attack)]
        if bad:
            raise NotImplementedError(
                "not ported to nerfool_tpu_torch: "
                + ", ".join(f"--{name}" for name in bad))

    def evaluate(self, max_views=None, verbose=True, out_dir=None):
        """Attack (per view, unless ``--no_attack``), render and measure
        every test view. Returns the results dict keyed like the JAX
        evaluator's (per-view rows plus means), also written to
        ``out_dir/psnr_<scene>.txt`` when given; rows also carry
        ``render_seconds``, host time of the render ending in a device
        synchronize, and after an attack ``attack_seconds``."""
        args = self.args
        self._check_ported()
        scene = args.eval_scenes[0] if args.eval_scenes else args.eval_dataset
        psnr_fn, ssim_fn = ((img2psnr, ssim_windowed)
                            if args.backbone == "gnt" else (psnr, ssim))
        results = {scene: {}}
        rows_acc = []
        n_views = len(self.test_dataset)
        if max_views:
            n_views = min(n_views, max_views)

        delta = None
        for i in range(n_views):
            data = self.test_dataset[i]
            file_id = (os.path.splitext(os.path.basename(data["rgb_path"]))[0]
                       or f"view{i:03d}")
            row = {}
            if args.no_attack:
                src = self._make_src(data)
            elif args.use_trans_attack and i > 0:
                # transfer attack: view 0's delta on this view's sources
                src = self._make_src(data)
            else:
                if verbose:
                    print(f"[{file_id}] view-specific attack "
                          f"({args.adv_iters} iters)...", flush=True)
                delta, src, _ = self.attack_view_specific(data,
                                                          verbose=verbose)
                row["attack_seconds"] = self.last_attack["seconds"]
            self._sync()
            t0 = time.perf_counter()
            with torch.inference_mode():
                ret = self.render_view(data, src, delta)
            self._sync()
            row["render_seconds"] = time.perf_counter() - t0
            gt = self._tensor(np.asarray(data["rgb"])[::args.render_stride,
                                                      ::args.render_stride])
            for level, name in (("outputs_coarse", "coarse"),
                                ("outputs_fine", "fine")):
                row[f"{name}_lpips"] = float("nan")
                if ret[level] is None:
                    row[f"{name}_psnr"] = row[f"{name}_ssim"] = float("nan")
                    continue
                pred = torch.clamp(ret[level]["rgb"], 0, 1)
                row[f"{name}_psnr"] = float(psnr_fn(pred, gt))
                row[f"{name}_ssim"] = float(ssim_fn(pred, gt))
            results[scene][file_id] = row
            rows_acc.append([row["coarse_psnr"], row["fine_psnr"],
                             row["coarse_ssim"], row["fine_ssim"],
                             row["coarse_lpips"], row["fine_lpips"]])
            if verbose:
                print(f"{scene} {file_id}: coarse/fine psnr "
                      f"{row['coarse_psnr']:.3f}/{row['fine_psnr']:.3f}  ssim "
                      f"{row['coarse_ssim']:.3f}/{row['fine_ssim']:.3f}  "
                      f"render {row['render_seconds']:.3f} s", flush=True)

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            means = (np.nanmean(np.array(rows_acc), axis=0)
                     if rows_acc else np.full(6, np.nan))
        for j, key in enumerate(("coarse_mean_psnr", "fine_mean_psnr",
                                 "coarse_mean_ssim", "fine_mean_ssim",
                                 "coarse_mean_lpips", "fine_mean_lpips")):
            results[scene][key] = float(means[j])
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"psnr_{scene}.txt"), "w") as f:
                f.write(str(results))
        return results
