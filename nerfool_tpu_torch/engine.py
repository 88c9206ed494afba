"""Clean whole-frame evaluator (port of the no-attack, view-specific path of
``nerfool_tpu/attack/engine.py`` ``AdvEvaluator``): every test view is
rendered whole-frame with IBRNet or GNT from its own source views, then
measured with PSNR and SSIM in the backbone's protocol (TF's for IBRNet,
``img2psnr`` and windowed SSIM for GNT). LPIPS is not ported and reads NaN.

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

from nerfool_tpu.data import dataset_dict
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
        self._bspg_cfg = {}  # n_src -> RenderConfig
        self._bspg_hw = None

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _make_src(self, data):
        return {"rgbs": self._tensor(data["src_rgbs"]),
                "cameras": self._tensor(data["src_cameras"]).reshape(-1, 34)}

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
        base = dataclasses.replace(self.render_cfg,
                                   gnt_fused_chain=self._fused_chain())
        if not getattr(args, "use_bspg", True):
            return base
        if n_src in self._bspg_cfg:
            return self._bspg_cfg[n_src]
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
        self._bspg_cfg[n_src] = dataclasses.replace(base, bspg_specs=specs)
        return self._bspg_cfg[n_src]

    def render_view(self, data, src):
        """Whole-frame render of one test view from its source views."""
        args = self.args
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
        feats = self.bundle.extract_features(src["rgbs"])
        rcfg = self.view_render_cfg(int(src["cameras"].shape[0]))
        if rcfg.bspg_specs is not None and self._bspg_hw != (h, w):
            raise ValueError(f"BSPG plan covers {self._bspg_hw} frames, "
                             f"not {(h, w)}")
        return render_single_image(
            self.bundle.nets, batch, feats, rcfg, h, w, src["rgbs"],
            src["cameras"], chunk_size=args.chunk_size,
            render_stride=args.render_stride)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def evaluate(self, max_views=None, verbose=True):
        """Render and measure every test view. Returns the results dict keyed
        like the JAX evaluator's (per-view rows plus means); rows also carry
        ``render_seconds``, host time of the render ending in a device
        synchronize."""
        args = self.args
        if not (args.no_attack and args.view_specific):
            raise NotImplementedError(
                "the port evaluates the clean per-view path only "
                "(no_attack with view_specific)")
        scene = args.eval_scenes[0] if args.eval_scenes else args.eval_dataset
        psnr_fn, ssim_fn = ((img2psnr, ssim_windowed)
                            if args.backbone == "gnt" else (psnr, ssim))
        results = {scene: {}}
        rows_acc = []
        n_views = len(self.test_dataset)
        if max_views:
            n_views = min(n_views, max_views)

        for i in range(n_views):
            data = self.test_dataset[i]
            file_id = (os.path.splitext(os.path.basename(data["rgb_path"]))[0]
                       or f"view{i:03d}")
            src = self._make_src(data)
            self._sync()
            t0 = time.perf_counter()
            ret = self.render_view(data, src)
            self._sync()
            row = {"render_seconds": time.perf_counter() - t0}
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
        return results
