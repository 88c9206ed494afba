"""Adversarial and clean whole-frame evaluator (port of
``nerfool_tpu/attack/engine.py`` ``AdvEvaluator``). View-specific
(``--view_specific``): per test view, ``adv_iters`` attack iterations on the
perturbation ``delta`` of the view's own source images
(``attack/attack.py``), then the whole-frame render from the perturbed
sources. Universal (the default): one ``delta`` on a fixed global source set
(``--use_center_view``: the views nearest the rig's centre), optimised over
train-split target views streamed by a shuffled loader (``--use_unseen_views``:
each target's pose replaced by an interpolated unseen pose, with a pseudo
ground truth), then every test view rendered from that perturbed set.
``--no_attack`` gives the clean rows of either. After either attack the
defenses run on the attacked sources, as in the JAX evaluator:
``--use_purification`` (``attack/purify.py``: a defensive perturbation
optimized over streamed train views, then added to ``delta``), then
``--def_random_noise`` (Gaussian noise on ``delta``). ``--use_clean_color``
/ ``--use_clean_density`` render the test views as hybrids of the attacked
and the clean sources' features; ``--geo_noise`` adds noise to IBRNet's
sigma in the attack's renders and the evaluator's, drawn from the
evaluator's generator. Renders are measured with PSNR and SSIM in the
backbone's protocol (TF's for IBRNet, ``img2psnr`` and windowed SSIM for
GNT), and with LPIPS when ``--lpips_weights`` names a weights file (IBRNet's
convention scales [0, 1] images to [-1, 1], GNT's feeds them raw; without
weights LPIPS reads NaN, as in the JAX evaluator). With an ``out_dir`` the
evaluator writes the JAX evaluator's image dumps (``utils/vis.py``).

The attack runs in float32 on the per-tap gather. ``--gnt_fused_attack``
routes the differentiated GNT step through the ray-attention kernel
(``ops/ray_attention.py``, forward and backward), ``--gnt_fused_attn on``
the no-grad f32 GNT renders, ``--gnt_fused_vt`` their view attention
through its forward-only kernel (``ops/view_attention.py``; ``auto``, the
default, = on a CUDA device); on the CPU each takes its kernel's plain
version.

Both backbones render in float32 or bfloat16 (``--compute_dtype``: the
aggregator and its inputs), and ``--feature_dtype bfloat16`` runs the
feature net's convolutions in bf16 with f32 outputs. ``--gnt_fused_chain``
resolves as in the JAX evaluator: ``auto`` runs bf16 whole-frame GNT renders
on a CUDA device through the whole-chain kernel (``ops/chain.py``), ``on``
forces the chain (its plain version on the CPU), ``off`` keeps the module
path. f32 renders take the module path either way.

Whole-frame renders take the per-tap gather by default; ``--use_bspg
True`` takes the block segment-patch gather: it is planned once over every
camera the dataset can emit, with one uniform worst-case slot budget across
the ``n_src`` source slots, so one plan serves every view. Where no plan can
serve a render, the render takes the per-tap gather, as the JAX evaluator's
do, and the evaluator prints one line naming the reason, once per reason: a
loader without ``target_cameras()``, a camera set no patch size covers, a
frame of another size than the planned one, or the camera-pose attack
(``--perturb_camera``), which moves the source cameras out of the planned
set. The route is chosen before any launch.

Launched as one process per card (``torchrun``: ``WORLD_SIZE`` > 1 in the
environment), the evaluator joins the process group
(``parallel/distributed.initialize``) and shares the rays of every attack
step and the chunks of every whole-frame render among the ranks
(``parallel/mesh.RaySplit``); every rank then holds the same losses,
``delta`` and frames, and rank 0 alone writes the results, the dumps and
the attack checkpoints. ``--shard_rays False`` keeps every rank on the
whole work; a single process runs exactly as without a group. The
purification steps are not split (each rank runs them whole, alike).
``retarget`` points the evaluator at another scene, keeping the model and
the random stream (``python -m nerfool_tpu_torch.sweep``).
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
import warnings

import numpy as np
import torch

from nerfool_tpu_torch.attack.attack import (
    AttackConfig,
    init_attack_state,
    make_attack_step,
)
from nerfool_tpu_torch.attack.purify import (
    PurifyConfig,
    apply_random_noise_defense,
    make_purify_step,
)
from nerfool_tpu_torch.attack.geo_interp import sample_unseen_pose
from nerfool_tpu_torch.config import on_off_auto
from nerfool_tpu_torch.data import dataset_dict
from nerfool_tpu_torch.data.base import Loader
from nerfool_tpu_torch.device import resolve_device
from nerfool_tpu_torch.metrics.image import img2psnr, psnr, ssim, ssim_windowed
from nerfool_tpu_torch.metrics.lpips import LPIPS, load_lpips_weights
from nerfool_tpu_torch.models.bundle import create_model
from nerfool_tpu_torch.models.resunet import feature_hw
from nerfool_tpu_torch.parallel.distributed import (initialize,
                                                    is_main_process,
                                                    local_device)
from nerfool_tpu_torch.parallel.mesh import ray_split
from nerfool_tpu_torch.render.render_image import render_single_image
from nerfool_tpu_torch.render.render_rays import RenderConfig
from nerfool_tpu_torch.utils.cameras import get_rays, transform_src_cameras
from nerfool_tpu_torch.utils.logging import save_run_config
from nerfool_tpu_torch.utils.vis import colorize_np, to8b, write_png


def render_config_from_args(args) -> RenderConfig:
    if args.backbone not in ("ibrnet", "gnt"):
        raise ValueError(f"unknown backbone {args.backbone!r}")
    if args.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"--compute_dtype {args.compute_dtype} (float32 or "
                         "bfloat16)")
    gnt = args.backbone == "gnt"
    return RenderConfig(n_samples=args.N_samples,
                        n_importance=args.N_importance,
                        inv_uniform=bool(args.inv_uniform),
                        det=bool(args.det),
                        white_bkgd=bool(args.white_bkgd),
                        backbone=args.backbone,
                        single_net=gnt and bool(args.single_net),
                        ret_alpha=not gnt or bool(args.ret_alpha),
                        stop_camera_grad=not gnt and not getattr(
                            args, "perturb_camera_no_detach", False),
                        geo_noise=float(args.geo_noise or 0.0),
                        use_clean_color=bool(args.use_clean_color),
                        use_clean_density=bool(args.use_clean_density),
                        compute_dtype=args.compute_dtype)


def frame_render_config(args, device) -> RenderConfig:
    """Render config of whole-frame renders on ``device``, before any BSPG
    plan: ``--gnt_fused_chain`` (auto = on a CUDA device), ``--gnt_fused_attn
    on`` and ``--gnt_fused_vt`` (auto = on a CUDA device) for GNT. The
    view-attention kernel has no backward, so the attack step's config
    never carries it."""
    gnt = args.backbone == "gnt"
    cuda = torch.device(device).type == "cuda"
    chain = getattr(args, "gnt_fused_chain", "auto")
    vt = on_off_auto(getattr(args, "gnt_fused_vt", "auto"))
    return dataclasses.replace(
        render_config_from_args(args),
        gnt_fused_chain=gnt and (chain == "on" or (chain == "auto" and cuda)),
        gnt_fused_attn=gnt and getattr(args, "gnt_fused_attn", "auto") == "on",
        gnt_fused_vt=gnt and (vt == "on" or (vt == "auto" and cuda)))


def build_attack_config(args, h, w) -> AttackConfig:
    return AttackConfig(
        h=h, w=w,
        epsilon=float(args.epsilon), adv_lr=args.adv_lr,
        adv_iters=args.adv_iters, use_adam=args.use_adam,
        adam_lr=args.adam_lr, lr_step_size=args.lr_step_size,
        lr_gamma=args.lr_gamma, n_rand=args.N_rand,
        sample_mode=args.sample_mode, center_ratio=args.center_ratio,
        use_patch_sampling=args.use_patch_sampling,
        patch_size=args.patch_size,
        use_pseudo_gt=args.use_pseudo_gt or args.use_unseen_views,
        density_loss=args.density_loss, depth_var_loss=args.depth_var_loss,
        depth_diff_loss=args.depth_diff_loss,
        depth_smooth_loss=args.depth_smooth_loss,
        depth_consistency_loss=args.depth_consistency_loss,
        ds_rgb=args.ds_rgb, resize_factor=args.resize_factor,
        camera_consistency_loss=args.camera_consistency_loss,
        cam_src2tar=args.cam_src2tar, cam_tar2src=args.cam_tar2src,
        cam_depth=args.cam_depth,
        perturb_camera_no_detach=args.perturb_camera_no_detach,
        use_pcgrad=args.use_pcgrad, major_loss=args.major_loss,
        perturb_camera=args.perturb_camera,
        perturb_camera_no_opt=args.perturb_camera_no_opt,
        zero_camera_init=args.zero_camera_init,
        rot_epsilon=args.rot_epsilon, trans_epsilon=args.trans_epsilon)


def save_attack_state(path, state, meta=None):
    """Checkpoint the attack state (delta, camera parameters, Adam moments,
    step) as CPU tensors, with ``meta`` (iterations done, the states of the
    random streams), so that a long universal attack can be resumed."""
    cpu = {k: v.detach().cpu() if torch.is_tensor(v) else v
           for k, v in state.items()}
    tmp = f"{path}.tmp"
    torch.save({"state": cpu, "meta": meta or {}}, tmp)
    os.replace(tmp, path)


def load_attack_state(path, device="cpu"):
    """:return: (state with its tensors on ``device``, meta)"""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = {k: v.to(device) if torch.is_tensor(v) else v
             for k, v in blob["state"].items()}
    return state, blob["meta"]


class Evaluator:
    def __init__(self, args, bundle=None, dataset_kwargs=None, device="cuda",
                 seed=0):
        args.det = True  # the reference forces deterministic sampling
        self.args = args
        # one process per card: a launcher's WORLD_SIZE > 1 joins the group
        self.split = None
        if getattr(args, "shard_rays", True):
            if int(os.environ.get("WORLD_SIZE", "1")) > 1:
                initialize(args, device=device)
            self.split = ray_split()
        self.device = resolve_device(
            local_device(device) if self.split is not None else device)
        self.render_cfg = render_config_from_args(args)
        self.bundle = bundle if bundle is not None else create_model(
            args=args, seed=seed, device=self.device)
        self.dataset_kwargs = dataset_kwargs or {}
        self.test_dataset = self._dataset("test")
        # n_src -> (spec_feat, spec_rgb), or the reason no plan exists
        self._bspg_specs = {}
        self._bspg_hw = None
        self._per_tap_said = set()
        # the attack's random draws (delta's init, the ray subsets)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        # the newest attack's losses, seconds, loss terms and final state
        self.last_attack = None
        self.last_purify = None  # and of the newest purification
        self.last_defenses = []  # the defenses run after the newest attack

    def retarget(self, args):
        """Point the evaluator at another scene or dataset (``args``),
        keeping the model bundle, the generator and the dataset keywords.
        The BSPG plans depend on the cameras, so they are dropped and made
        again for the new scene on first use."""
        args.det = True
        self.args = args
        self.render_cfg = render_config_from_args(args)
        self.test_dataset = self._dataset("test")
        self._bspg_specs = {}
        self._bspg_hw = None
        self._per_tap_said = set()
        return self

    def _dataset(self, mode, **kwargs):
        args = self.args
        return dataset_dict[args.eval_dataset](
            args, mode, scenes=args.eval_scenes, **kwargs,
            **self.dataset_kwargs)

    def global_src(self, clean_feats=False):
        """The global source set, shared by every target view: the test
        split's first sample with ``use_glb_src`` as ``--use_center_view``
        says."""
        data = self._dataset("test", use_glb_src=self.args.use_center_view)[0]
        return self._make_src(data, clean_feats=clean_feats)

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
        if data.get("src_depths") is not None:
            src["depths"] = self._tensor(data["src_depths"])
        if clean_feats:
            with torch.no_grad():
                src["featmaps_clean"] = self.bundle.extract_features(
                    src["rgbs"])
        return src

    def view_render_cfg(self, n_src):
        """Render config for whole-frame renders with ``n_src`` source views;
        plans BSPG on first use (numpy, host), or takes the per-tap gather
        where no plan can be made (``frame_render_config`` for the fused
        routes)."""
        args = self.args
        base = frame_render_config(args, self.device)
        if not getattr(args, "use_bspg", True):
            return base
        if getattr(args, "perturb_camera", False):
            return self._per_tap(base, "--perturb_camera moves the source "
                                 "cameras out of the BSPG plan")
        if n_src not in self._bspg_specs:
            self._bspg_specs[n_src] = self._plan(n_src)
        specs = self._bspg_specs[n_src]
        if isinstance(specs, str):
            return self._per_tap(base, specs)
        return dataclasses.replace(base, bspg_specs=specs)

    def _per_tap(self, cfg, reason):
        """``cfg`` without BSPG specs; says why once per reason."""
        if reason not in self._per_tap_said:
            print(f"whole-frame renders take the per-tap gather: {reason}",
                  flush=True)
            self._per_tap_said.add(reason)
        return dataclasses.replace(cfg, bspg_specs=None)

    def _plan(self, n_src):
        """The BSPG specs of ``n_src`` source slots over every camera of the
        test split, or the reason there are none."""
        from nerfool_tpu_torch.ops.bspg import plan_render_specs

        fn = getattr(self.test_dataset, "target_cameras", None)
        got = fn() if fn is not None else None
        if got is None:
            return (f"{type(self.test_dataset).__name__} exposes no "
                    "target_cameras()")
        cams_all = np.asarray(got[0], np.float64)
        dr = np.asarray(got[1], np.float64)
        h, w = int(cams_all[0][0]), int(cams_all[0][1])
        blk = int(getattr(self.args, "bspg_block", 8))
        specs = plan_render_specs(cams_all, cams_all, dr, (h, w),
                                  feature_hw(h, w), block=(blk, blk),
                                  render_stride=self.args.render_stride)
        if specs is None:
            return ("no admissible patch size covers the epipolar spans of "
                    "this camera set")
        self._bspg_hw = (h, w)
        # any candidate camera may fill any of the n_src slots: one group with
        # the worst-case crossing budget
        return tuple(
            dataclasses.replace(
                sp, groups=((tuple(range(n_src)), max(k for _, k in sp.groups)),))
            for sp in specs)

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
        """Render config of the differentiated attack step: with
        ``--gnt_fused_attack`` GNT's ray attention through the fused kernel
        (its plain version on the CPU)."""
        args = self.args
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
        step = make_attack_step(self.bundle, self._grad_render_cfg(), cfg,
                                split=self.split)
        src = self._make_src(data, clean_feats=cfg.use_pseudo_gt)
        state = init_attack_state(self.generator, cfg, src["rgbs"], delta)
        n_iters = args.adv_iters
        every = max(1, n_iters // 10)
        losses, aux = [], None
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
        self.last_attack = dict(
            self._loop_record(t0, losses), state=state,
            terms=tuple(k for k in (aux or {}) if k != "loss"))
        return self._finalize(state, src, cfg)

    def _loop_record(self, t0, losses):
        """Host seconds since ``t0`` ending in a device synchronize, and the
        loop's iterations and losses."""
        self._sync()
        return {"seconds": time.perf_counter() - t0, "iters": len(losses),
                "losses": (torch.stack(losses).cpu() if losses
                           else torch.zeros(0))}

    def attack_universal(self, verbose=False, ckpt_path=None):
        """Optimize one ``delta`` on the global source set over train-split
        target views, one per iteration, streamed by a shuffled loader (seed
        0). Under ``--use_unseen_views`` each target's pose is replaced by
        one interpolated between three of the train split's render poses.
        ``delta`` starts from a draw of the evaluator's generator. Returns
        (delta, src_glb, src_cameras), the cameras moved by
        the camera-pose attack's parameters; ``last_attack`` as for the
        view-specific loop, over the iterations this call ran.

        ``ckpt_path``: the attack state, the iterations done and the states
        of the random streams are saved there every ``--i_attack_ckpt``
        iterations and at the end; a file found there is resumed from, the
        loader skipped ahead, so that the resumed run repeats the unbroken
        one.
        """
        args = self.args
        train_dataset = self._dataset("train")
        render_poses = getattr(train_dataset, "render_poses_spiral", None)
        if render_poses is None:
            render_poses = getattr(train_dataset, "render_poses", None)
        rng = np.random.RandomState(0)  # the unseen poses
        n_iters = args.adv_iters
        ckpt_every = int(getattr(args, "i_attack_ckpt", 0) or 0)
        state, start_iter = None, 0
        if ckpt_path and os.path.exists(ckpt_path):
            state, meta = load_attack_state(ckpt_path, self.device)
            start_iter = int(meta["iters_done"])
            self.generator.set_state(meta["generator"])
            rng.set_state(meta["pose_rng"])
            if verbose:
                print(f"  resuming universal attack from iter {start_iter}",
                      flush=True)
        it = iter(Loader(train_dataset, shuffle=True, seed=0,
                         num_workers=args.workers, infinite=True,
                         skip=start_iter))
        data = next(it)
        target, (h, w) = self._make_target(data)
        cfg = build_attack_config(args, h, w)
        step = make_attack_step(self.bundle, self._grad_render_cfg(), cfg,
                                split=self.split)
        src = self.global_src(clean_feats=cfg.use_pseudo_gt)
        if state is None:
            state = init_attack_state(self.generator, cfg, src["rgbs"])

        every = max(1, n_iters // 10)
        losses, aux = [], None
        self._sync()
        t0 = time.perf_counter()
        for i in range(start_iter, n_iters):
            if args.use_unseen_views:
                pose = sample_unseen_pose(
                    rng, render_poses, interp_upbound=args.interp_upbound,
                    decouple=args.decouple_interp_range,
                    upbound_rot=args.interp_upbound_rot,
                    upbound_trans=args.interp_upbound_trans,
                    sample_based_on_depth=args.sample_based_on_depth,
                    beta=args.beta, temp=args.temp)
                cam = np.asarray(data["camera"]).copy()
                cam[18:34] = pose.reshape(-1)[:16]
                data = dict(data, camera=cam)
            target, _ = self._make_target(data)
            state, aux = step(state, target, src, generator=self.generator)
            losses.append(aux["loss"])
            data = next(it)
            done = i + 1
            if verbose and (done % every == 0 or done == n_iters):
                print(f"  universal iter {done}/{n_iters} "
                      f"loss={float(aux['loss']):.5f} "
                      f"({(time.perf_counter() - t0) / (done - start_iter) * 1e3:.0f}"
                      " ms/iter)", flush=True)
            if ckpt_path and ckpt_every and is_main_process() and (
                    done % ckpt_every == 0 or done == n_iters):
                save_attack_state(ckpt_path, state, {
                    "iters_done": done,
                    "generator": self.generator.get_state(),
                    "pose_rng": rng.get_state()})
        self.last_attack = dict(
            self._loop_record(t0, losses), state=state,
            terms=tuple(k for k in (aux or {}) if k != "loss"))
        return self._finalize(state, src, cfg)

    def _finalize(self, state, src, cfg):
        """The attacked ``delta`` after the defenses (purification, then
        the noise defense), the sources, and the cameras moved by the
        camera-pose attack. ``last_defenses`` names the defenses run."""
        args = self.args
        delta = state["delta"]
        src_cameras = src["cameras"]
        if cfg.perturb_camera:
            src_cameras = transform_src_cameras(src_cameras, state["rot"],
                                                state["trans"])
        self.last_defenses = []
        if args.use_purification:
            delta = self._purify(delta, src)
            self.last_defenses.append("purification")
        if args.def_random_noise > 0:
            delta = apply_random_noise_defense(self.generator, delta,
                                               args.def_random_noise)
            self.last_defenses.append("random_noise")
        return delta, src, src_cameras

    def _purify(self, delta, src):
        """``--purif_iters`` purification steps over train-split views
        streamed by a shuffled loader (seed 1); returns ``delta + purif``.
        ``last_purify`` keeps the losses and the host seconds of the loop,
        ending in a device synchronize."""
        args = self.args
        it = iter(Loader(self._dataset("train"), shuffle=True, seed=1,
                         num_workers=args.workers, infinite=True))
        _, (h, w) = self._make_target(next(it))
        cfg = PurifyConfig(
            h=h, w=w, purif_epsilon=args.purif_epsilon,
            purif_iters=args.purif_iters, adam_lr=args.adam_lr or 1e-3,
            lr_step_size=args.lr_step_size, lr_gamma=args.lr_gamma,
            n_rand=args.N_rand, sample_mode=args.sample_mode,
            center_ratio=args.center_ratio,
            use_patch_sampling=args.use_patch_sampling,
            patch_size=args.patch_size,
            use_self_purification=args.use_self_purification,
            purif_consistency_loss=args.purif_consistency_loss)
        init_state, step = make_purify_step(self.bundle,
                                            self._grad_render_cfg(), cfg)
        state = init_state(self.generator, src["rgbs"], delta)
        losses = []
        self._sync()
        t0 = time.perf_counter()
        for _ in range(args.purif_iters):
            target, _ = self._make_target(next(it))
            state, aux = step(state, target, src, delta,
                              generator=self.generator)
            losses.append(aux["loss"])
        self.last_purify = self._loop_record(t0, losses)
        return delta + state["purif"]

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
        feats_clean = (self.bundle.extract_features(src["rgbs"])
                       if self.render_cfg.hybrid else None)
        rcfg = self.view_render_cfg(int(src_cameras.shape[0]))
        if rcfg.bspg_specs is not None and self._bspg_hw != (h, w):
            rcfg = self._per_tap(rcfg, f"the BSPG plan covers "
                                 f"{self._bspg_hw[0]}x{self._bspg_hw[1]} "
                                 f"frames, not {h}x{w}")
        return render_single_image(
            self.bundle.nets, batch, feats, rcfg, h, w, src["rgbs"],
            src_cameras, chunk_size=args.chunk_size,
            render_stride=args.render_stride, featmaps_clean=feats_clean,
            generator=self.generator, split=self.split)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _build_lpips(self):
        """The LPIPS metric on the device under the backbone's convention
        (IBRNet's results scale [0, 1] images to [-1, 1], GNT's feed them
        raw), or None without ``--lpips_weights``: LPIPS then reads NaN."""
        path = getattr(self.args, "lpips_weights", "")
        if not path:
            print("WARNING: --lpips_weights not set; LPIPS is unmeasurable and "
                  "will be recorded as NaN / excluded from means (export "
                  "weights with python -m "
                  "nerfool_tpu_torch.export_lpips_weights)", file=sys.stderr)
            return None
        model = LPIPS(normalize=self.args.backbone != "gnt")
        return model.load_params(load_lpips_weights(path)).to(
            self.device).eval()

    def _save_view_images(self, out_dir, file_id, name, pred, gt, outputs,
                          data):
        """A level's dumps, as the JAX evaluator writes them: the render, the
        ground truth (with the coarse level), the squared-error map, the
        depth in millimetres (uint16) and coloured, the accumulated
        weights."""
        path = lambda f: os.path.join(out_dir, f"{file_id}_{f}.png")
        write_png(path(f"pred_{name}"), to8b(pred))
        if name == "coarse":
            write_png(path("gt_rgb"), to8b(gt))
        err = np.sum((pred - gt) ** 2, axis=-1)
        write_png(path(f"err_map_{name}"),
                  to8b(colorize_np(err, range=(0.0, 1.0))))
        if outputs.get("depth") is not None:
            depth = outputs["depth"].float().cpu().numpy()
            write_png(path(f"depth_{name}"),
                      (depth.squeeze() * 1000.0).astype(np.uint16))
            drange = tuple(np.asarray(data["depth_range"]).reshape(-1)[:2])
            write_png(path(f"depth_vis_{name}"),
                      to8b(colorize_np(depth, range=drange)))
        if outputs.get("weights") is not None:
            acc = np.sum(outputs["weights"].float().cpu().numpy(), axis=-1)
            write_png(path(f"acc_map_{name}"),
                      to8b(colorize_np(acc, range=(0.0, 1.0))))

    def evaluate(self, max_views=None, verbose=True, out_dir=None,
                 save_images=True):
        """Attack (once on the global source set, or per view under
        ``--view_specific``; not at all under ``--no_attack``), render and
        measure every test view. Returns the results dict keyed like the JAX
        evaluator's (per-view rows plus means), also written to
        ``out_dir/psnr_<scene>.txt`` when given; rows also carry
        ``render_seconds``, host time of the render ending in a device
        synchronize, and after a view-specific attack ``attack_seconds``
        (the universal attack's are under the scene's ``attack_seconds``).
        In a process group rank 0 alone writes files. With an ``out_dir``
        the run's flags go to ``args.txt`` (and the
        config file to ``config.txt``) and, with ``save_images``, each
        view's dumps beside them: per level ``<id>_pred``, ``_err_map``,
        ``_depth`` (uint16, depth x 1000), ``_depth_vis`` and ``_acc_map``
        PNGs, ``<id>_gt_rgb.png`` and ``<id>_average.png`` (the sources'
        mean), and with ``--export_adv_source_img`` the perturbed sources
        as ``adv_src_<view>_<source>.png``.
        With ``--i_attack_ckpt`` and an ``out_dir`` the universal attack is
        checkpointed to and resumed from ``out_dir/attack_state.pt``."""
        args = self.args
        scene = args.eval_scenes[0] if args.eval_scenes else args.eval_dataset
        psnr_fn, ssim_fn = ((img2psnr, ssim_windowed)
                            if args.backbone == "gnt" else (psnr, ssim))
        lpips_fn = self._build_lpips()
        writes = bool(out_dir) and is_main_process()  # rank 0 alone writes
        if writes:
            save_run_config(out_dir, args)
        dump = bool(save_images and writes)
        results = {scene: {}}
        rows_acc = []
        n_views = len(self.test_dataset)
        if max_views:
            n_views = min(n_views, max_views)

        delta = src_glb = cams = None
        if not args.view_specific:
            if args.no_attack:
                src_glb = self.global_src()
            else:
                if verbose:
                    print("universal attack on the global source set "
                          f"({args.adv_iters} iters)...", flush=True)
                ckpt = (os.path.join(out_dir, "attack_state.pt")
                        if out_dir and getattr(args, "i_attack_ckpt", 0)
                        else None)
                if ckpt and writes:
                    os.makedirs(out_dir, exist_ok=True)
                delta, src_glb, cams = self.attack_universal(
                    verbose=verbose, ckpt_path=ckpt)
                results[scene]["attack_seconds"] = self.last_attack["seconds"]

        for i in range(n_views):
            data = self.test_dataset[i]
            file_id = (os.path.splitext(os.path.basename(data["rgb_path"]))[0]
                       or f"view{i:03d}")
            row = {}
            view_cams = None  # the source set's own cameras
            if src_glb is not None:
                src, view_cams = src_glb, cams
            elif args.no_attack:
                src = self._make_src(data)
            elif args.use_trans_attack and i > 0:
                # transfer attack: view 0's delta on this view's sources
                src = self._make_src(data)
            else:
                if verbose:
                    print(f"[{file_id}] view-specific attack "
                          f"({args.adv_iters} iters)...", flush=True)
                delta, src, view_cams = self.attack_view_specific(
                    data, verbose=verbose)
                row["attack_seconds"] = self.last_attack["seconds"]
            self._sync()
            t0 = time.perf_counter()
            with torch.inference_mode():
                ret = self.render_view(data, src, delta, view_cams)
            self._sync()
            row["render_seconds"] = time.perf_counter() - t0
            gt_np = np.asarray(data["rgb"])[::args.render_stride,
                                            ::args.render_stride]
            gt = self._tensor(gt_np)
            for level, name in (("outputs_coarse", "coarse"),
                                ("outputs_fine", "fine")):
                row[f"{name}_lpips"] = float("nan")
                if ret[level] is None:
                    row[f"{name}_psnr"] = row[f"{name}_ssim"] = float("nan")
                    continue
                pred = torch.clamp(ret[level]["rgb"], 0, 1)
                row[f"{name}_psnr"] = float(psnr_fn(pred, gt))
                row[f"{name}_ssim"] = float(ssim_fn(pred, gt))
                if lpips_fn is not None:
                    with torch.no_grad():
                        row[f"{name}_lpips"] = float(
                            lpips_fn(pred[None], gt[None])[0])
                if dump:
                    self._save_view_images(
                        out_dir, file_id, name, pred.float().cpu().numpy(),
                        gt_np, ret[level], data)
            if dump:
                rgbs = src["rgbs"].cpu().numpy()
                write_png(os.path.join(out_dir, f"{file_id}_average.png"),
                          to8b(np.mean(rgbs, axis=0)))
                if args.export_adv_source_img:
                    adv = (src["rgbs"] if delta is None
                           else src["rgbs"] + delta).detach().cpu().numpy()
                    for j in range(adv.shape[0]):
                        write_png(os.path.join(out_dir, f"adv_src_{i}_{j}.png"),
                                  to8b(adv[j]))
            results[scene][file_id] = row
            rows_acc.append([row["coarse_psnr"], row["fine_psnr"],
                             row["coarse_ssim"], row["fine_ssim"],
                             row["coarse_lpips"], row["fine_lpips"]])
            if verbose:
                print(f"{scene} {file_id}: coarse/fine psnr "
                      f"{row['coarse_psnr']:.3f}/{row['fine_psnr']:.3f}  ssim "
                      f"{row['coarse_ssim']:.3f}/{row['fine_ssim']:.3f}  "
                      f"lpips {row['coarse_lpips']:.3f}/"
                      f"{row['fine_lpips']:.3f}  "
                      f"render {row['render_seconds']:.3f} s", flush=True)

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            means = (np.nanmean(np.array(rows_acc), axis=0)
                     if rows_acc else np.full(6, np.nan))
        for j, key in enumerate(("coarse_mean_psnr", "fine_mean_psnr",
                                 "coarse_mean_ssim", "fine_mean_ssim",
                                 "coarse_mean_lpips", "fine_mean_lpips")):
            results[scene][key] = float(means[j])
        if writes:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"psnr_{scene}.txt"), "w") as f:
                f.write(str(results))
        return results
