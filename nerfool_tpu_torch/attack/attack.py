"""The attack step: one gradient-ascent update on the source-view
perturbation ``delta`` and, in the camera-pose attack, on the per-view
rotation and translation of the source cameras (port of
``nerfool_tpu/attack/attack.py``).

One iteration selects a random ray subset of the target view, re-extracts
the features of the perturbed sources, renders the subset, sums the enabled
loss terms, differentiates to ``delta`` (and ``rot``, ``trans``), and applies
the Adam or sign-PGD update followed by the eps-ball / image-box projection
and the clamps on the camera parameters. Gradient ascent is expressed as the
reference does it: negate the gradient and feed a standard descending
optimizer. With ``use_pcgrad`` every loss term is differentiated on its own
(one backward each over the shared graph) and the gradients of ``delta`` go
through gradient surgery (``attack/pcgrad.py``); the camera parameters keep
the summed gradient.

The multi-view-consistency terms warp a random source view's ground-truth
depth (``attack/warp.py``): ``depth_consistency_loss`` pulls the rendered
depth toward the source depth warped into the target (with ``ds_rgb`` on a
second render at ``resize_factor`` of the target's resolution), and
``camera_consistency_loss`` compares rgb and depth warped both ways between
the target and a source view, which drives the camera-pose attack.

Given a ``RaySplit`` (``parallel/mesh.py``) the step runs on every rank of
a process group alike: each rank runs the feature net on its own share of
the source views (whole views) and gathers the maps, draws the same rays
from the same generator, renders its contiguous share of each ray batch
(whole patches of patch-structured batches), and gathers the shares back,
so that every rank computes the losses of the whole batch. The gradients
flow through each rank's own rays only; the gather's backward sums the
maps' gradients over the ranks and hands each rank its own views' rows, so
``delta``'s gradient on a rank covers its own views, the camera parameters'
its own rays (``delta`` reaches the losses through the features alone).
Their sum over the ranks (one all-reduce, per objective under PCGrad,
before the surgery) is the one-process gradient. The update is then the
same on every rank.

The step is an eager function over a small state dict (``delta``, ``rot``,
``trans``, their Adam moments, the step count). The caller may pass the ray
indices ``sel`` (``sel_patch``, the dedicated depth-smooth patch batch;
``sel_half``, the rays of the ``ds_rgb`` render), the source views of the
consistency terms, the PCGrad task order and the initial values; otherwise
they are drawn from an explicit ``torch.Generator``. The aggregators' and
the feature net's parameters are frozen (``requires_grad=False``) while a
step runs, and only then: a trainer sharing the models finds their flags as
it left them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from nerfool_tpu_torch.attack import losses as L
from nerfool_tpu_torch.attack.pcgrad import pcgrad_combine
from nerfool_tpu_torch.attack.perturb import clamp, init_delta, project_delta
from nerfool_tpu_torch.attack.warp import forward_warp
from nerfool_tpu_torch.render.render_rays import (RenderConfig,
                                                  render_draws, render_rays,
                                                  share_draws)
from nerfool_tpu_torch.utils.cameras import get_rays_at, transform_src_cameras
from nerfool_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    """Static attack configuration. Field names track the CLI flags;
    epsilon / adv_lr are in /255 units."""

    h: int
    w: int
    epsilon: float = 8.0
    adv_lr: float = 2.0
    adv_iters: int = 100
    use_adam: bool = False
    adam_lr: float = 1e-3
    lr_step_size: int = 100
    lr_gamma: float = 0.5
    n_rand: int = 512
    sample_mode: str = "uniform"  # 'uniform' | 'center'
    center_ratio: float = 0.8
    use_patch_sampling: bool = False
    patch_size: int = 8
    use_pseudo_gt: bool = False
    # loss weights (0 = disabled)
    density_loss: float = 0.0
    depth_var_loss: float = 0.0
    depth_diff_loss: float = 0.0
    depth_smooth_loss: float = 0.0
    depth_consistency_loss: float = 0.0  # source depth warped to the target
    ds_rgb: bool = False  # depth consistency on a reduced-resolution render
    resize_factor: float = 0.5  # that render's scale
    camera_consistency_loss: float = 0.0  # rgb and depth warped both ways
    cam_src2tar: float = 0.0
    cam_tar2src: float = 0.0
    cam_depth: float = 0.0
    perturb_camera_no_detach: bool = False  # the render's rgb keeps its grad
    # gradient surgery
    use_pcgrad: bool = False
    major_loss: str = ""
    # camera-pose attack
    perturb_camera: bool = False
    perturb_camera_no_opt: bool = False
    zero_camera_init: bool = False
    rot_epsilon: float = 10.0  # degrees
    trans_epsilon: float = 0.1

    @property
    def eps(self):
        return self.epsilon / 255.0

    @property
    def alpha(self):
        return self.adv_lr / 255.0

    @property
    def rot_eps_rad(self):
        return self.rot_epsilon / 180.0 * math.pi

    def enabled_losses(self):
        """The enabled terms in JAX's order (the order of the sum and of
        PCGrad's tasks)."""
        names = ["rgb"]
        for name, flag in (("density", "density"), ("depth_var", "depth_var"),
                           ("depth_diff", "depth_diff"),
                           ("depth_cons", "depth_consistency"),
                           ("depth_smooth", "depth_smooth"),
                           ("camera_cons", "camera_consistency")):
            if getattr(self, f"{flag}_loss") > 0:
                names.append(name)
        return names


def draw_view(generator, n, device, given=None):
    """A source view's index in ``range(n)``, drawn from ``generator``
    unless given, as a one-element tensor: ``x[i][0]`` reads the view
    without waiting for the card (a 0-d index tensor would)."""
    if given is not None:
        return torch.as_tensor(given, device=device).reshape(1)
    return torch.randint(0, n, (1,), device=device, generator=generator)


def _distinct(generator, n, k, device):
    """k distinct indices below n: the top k of n uniform scores."""
    scores = torch.rand(n, device=device, generator=generator)
    return torch.topk(scores, k).indices


def patch_indices(x0, y0, patch_size, w):
    """Pixel indices of ``patch_size``^2 patches anchored at rows ``x0`` and
    columns ``y0`` ([n, 1] each), patch-major; inside a patch the row offset
    varies fastest, the order ``depth_smooth_loss`` reshapes."""
    p = patch_size
    ar = torch.arange(p, device=x0.device)
    dr = ar.repeat(p)[None]
    dc = ar.repeat_interleave(p)[None]
    return ((y0 + dc) + w * (x0 + dr)).reshape(-1)


def select_ray_indices(generator, cfg: AttackConfig, device="cpu"):
    """Random ray-subset selection.

    uniform: n_rand distinct pixels; center: distinct pixels within the
    central center_ratio box; patch: n_rand // patch_size^2 random patches.

    :param generator: ``torch.Generator`` on ``device``
    :return: [n] int64 row-major pixel indices
    """
    h, w = cfg.h, cfg.w
    if cfg.use_patch_sampling:
        p = cfg.patch_size
        n_patches = cfg.n_rand // (p ** 2)
        x0 = torch.randint(0, h - p + 1, (n_patches, 1), device=device,
                           generator=generator)
        y0 = torch.randint(0, w - p + 1, (n_patches, 1), device=device,
                           generator=generator)
        return patch_indices(x0, y0, p, w)
    if cfg.sample_mode == "center":
        bh = int(h * (1 - cfg.center_ratio) / 2.0)
        bw = int(w * (1 - cfg.center_ratio) / 2.0)
        hh = h - 2 * bh
        ww = w - 2 * bw
        sel = _distinct(generator, hh * ww, cfg.n_rand, device)
        u = torch.div(sel, ww, rounding_mode="floor") + bh  # row
        v = sel % ww + bw
        return v + w * u
    return _distinct(generator, h * w, cfg.n_rand, device)


def adam_lr(cfg: AttackConfig, step: int):
    """Staircase exponential decay of the Adam step size."""
    return cfg.adam_lr * cfg.lr_gamma ** (step // cfg.lr_step_size)


def adam_update(param, grad, m, v, step, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One descending Adam update at 0-based ``step`` (bias correction with
    ``step + 1``; ``eps`` added to ``sqrt(v_hat)``).

    :return: (param, m, v)
    """
    m = b1 * m + (1.0 - b1) * grad
    v = b2 * v + (1.0 - b2) * grad * grad
    m_hat = m / (1.0 - b1 ** (step + 1))
    v_hat = v / (1.0 - b2 ** (step + 1))
    return param - lr * m_hat / (torch.sqrt(v_hat) + eps), m, v


def init_attack_state(generator, cfg: AttackConfig, src_rgbs, delta=None,
                      rot=None, trans=None):
    """The attack state: ``delta`` (drawn uniformly in the eps-ball from
    ``generator`` unless given); the camera parameters ``rot`` and ``trans``
    ([V, 3]: zeros, or in the camera-pose attack without
    ``zero_camera_init`` drawn uniformly inside their bounds unless given);
    zero Adam moments (``m``, ``v`` of delta, ``m_rot`` ... of the camera
    parameters); step 0."""
    if delta is None:
        delta = init_delta(generator, src_rgbs, cfg.eps)
    delta = delta.detach().to(src_rgbs)
    n = src_rgbs.shape[0]

    def camera_param(given, bound):
        if given is not None:
            return given.detach().to(src_rgbs)
        if not cfg.perturb_camera or cfg.zero_camera_init:
            return src_rgbs.new_zeros((n, 3))
        u = torch.rand((n, 3), device=src_rgbs.device, generator=generator)
        return ((2.0 * u - 1.0) * bound).to(src_rgbs)

    state = {"delta": delta, "rot": camera_param(rot, cfg.rot_eps_rad),
             "trans": camera_param(trans, cfg.trans_epsilon), "step": 0}
    for key, name in (("", "delta"), ("_rot", "rot"), ("_trans", "trans")):
        state["m" + key] = torch.zeros_like(state[name])
        state["v" + key] = torch.zeros_like(state[name])
    return state


@contextlib.contextmanager
def _frozen(modules):
    """``requires_grad`` off on every parameter of ``modules`` inside the
    block, and as it was after it."""
    params = [p for m in modules if m is not None for p in m.parameters()]
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)


def _k3(cam):
    """The [3, 3] intrinsics of a camera vector."""
    return cam[2:18].reshape(4, 4)[:3, :3]


def _c2w(cam):
    return cam[18:34].reshape(4, 4)


def make_attack_step(bundle, render_cfg: RenderConfig, cfg: AttackConfig,
                     split=None):
    """Build the attack step for ``bundle``. Its parameters are frozen
    while a step runs (only ``delta`` and the camera parameters are
    differentiated) and get their ``requires_grad`` flags back when it
    returns. ``split``: a ``parallel.mesh.RaySplit`` to share the source
    views' feature net and each ray batch among the ranks of a group
    (None: one process).

    step(state, target, src, generator=None, sel=None, sel_patch=None,
         pc_order=None, depth_src_id=None, camera_src_id=None,
         sel_half=None, samples=None) -> (state, aux)
      target: {'camera' [34], 'rgb' [H*W, 3] or None, 'depth' [H*W] or None,
               'depth_range' [1, 2]}
      src:    {'rgbs' [V, Hs, Ws, 3], 'cameras' [V, 34],
               'featmaps_clean': (coarse, fine) or None,
               'depths' [V, Hs, Ws] (the consistency terms)}
      sel, sel_patch, sel_half: ray indices of the main batch, of the
        dedicated depth-smooth patch batch and of the ``ds_rgb`` render;
        drawn from ``generator`` when None
      depth_src_id, camera_src_id: the source view each consistency term
        warps; drawn from ``generator`` when None
      samples: the sampling draws of the main batch (and of its pseudo-GT
        render), ``render_rays.render_draws``' 'samples' (pixelNeRF's four
        draws, or None); drawn from ``generator`` when None (other renders
        of the step draw their own)
      pc_order: with ``use_pcgrad`` and no major loss, the order in which
        each loss's gradient is projected against the others; drawn from
        ``generator`` when None
      aux: {'loss': total, plus one entry per enabled term}, detached
    """
    if cfg.density_loss > 0 and not cfg.use_pseudo_gt:
        raise ValueError("--density_loss requires --use_pseudo_gt")
    modules = (bundle.feature_net, bundle.net_coarse, bundle.net_fine)
    nets = bundle.nets
    # the attack samples random pixels: per-tap gather, never the block
    # plan; and it renders the attacked features alone, as the reference's
    # attack does (hybrid renders are the evaluator's)
    render_cfg = dataclasses.replace(render_cfg, bspg_specs=None,
                                     use_clean_color=False,
                                     use_clean_density=False)
    gt_cfg = dataclasses.replace(render_cfg, geo_noise=0.0)

    loss_names = cfg.enabled_losses()
    major_idx = (loss_names.index(cfg.major_loss)
                 if cfg.major_loss in loss_names else None)

    # the rays of a patch-structured batch are split in whole patches
    patch_unit = cfg.patch_size ** 2
    main_unit = patch_unit if cfg.use_patch_sampling else 1

    def render_at(feats, cam, target, src, src_cams, sel, w, generator,
                  rcfg=render_cfg, unit=1, samples=None):
        n = sel.shape[0]

        def render(rows=None):
            part = sel if rows is None else sel[rows]
            rays_o, rays_d = get_rays_at(part, w, cam[2:18].reshape(4, 4),
                                         _c2w(cam))
            batch = {"ray_o": rays_o, "ray_d": rays_d,
                     "depth_range": target["depth_range"],
                     "camera": cam[None]}
            draws = {"samples": samples}
            if rows is not None:  # the whole batch's draws, this rank's rows
                dtype = torch.promote_types(feats[0].dtype, torch.float32)
                draws, = share_draws(generator, rcfg, [n], rows, dtype,
                                     part.device, samples=samples)
            return render_rays(nets, batch, feats, rcfg, src["rgbs"],
                               src_cams, generator=generator, **draws)

        if split is None:
            return render()
        return split.render(render, n, unit)

    def localize(x):
        """A per-ray tensor every rank computes in full: its gradient on
        this rank's rays only (identity without a split)."""
        return x if split is None or x is None else split.localize(x)

    def depth_consistency(feats, ret, target, src, src_cams, draws,
                          generator):
        """A source view's depth warped into the target, against the
        rendered depth; with ``ds_rgb`` on its own render at
        ``resize_factor`` of the target's resolution, whose intrinsics (and
        the source's, for the warp) are scaled by it."""
        sid = draws["depth_src_id"]
        src_cam, tar_cam = src_cams[sid][0], target["camera"]
        k_src = _k3(src_cam)
        if cfg.ds_rgb:
            rf = cfg.resize_factor
            hh, ww = int(cfg.h * rf), int(cfg.w * rf)
            scale = torch.ones(4, 4, dtype=tar_cam.dtype,
                               device=tar_cam.device)
            scale[:2, :3] = rf
            tar_cam = torch.cat([tar_cam.new_tensor([hh, ww]),
                                 (tar_cam[2:18].reshape(4, 4)
                                  * scale).reshape(-1), tar_cam[18:34]])
            sel = draws["sel_half"]
            with span("attack.render"):
                ret = render_at(feats, tar_cam, target, src, src_cams, sel,
                                ww, generator, unit=main_unit)
            # the first two rows scaled, [2, 2] stays 1
            k_src = k_src * rf + torch.diag(
                k_src.new_tensor([0.0, 0.0, 1.0 - rf]))
        else:
            sel = draws["sel"]
        depth_proj = localize(forward_warp(
            sel, None, src["depths"][sid][0], k_src, _c2w(src_cam),
            _k3(tar_cam), _c2w(tar_cam))[3])
        return L.both_levels(lambda o: L.smooth_l1(o["depth"], depth_proj,
                                                   depth_proj > 0), ret)

    def camera_consistency(ret, target, src, src_cams, draws):
        """rgb and depth warped source -> target and target -> source
        through the ground-truth depths of both views."""
        sid, sel = draws["camera_src_id"], draws["sel"]
        src_cam, tar_cam = src_cams[sid][0], target["camera"]
        k_tar, e_tar = _k3(tar_cam), _c2w(tar_cam)
        k_sv, e_sv = _k3(src_cam), _c2w(src_cam)
        rgb_src, depth_src = src["rgbs"][sid][0], src["depths"][sid][0]
        _, _, rgb_s2t, depth_s2t = forward_warp(
            sel, rgb_src, depth_src, k_sv, e_sv, k_tar, e_tar, src2tar=True)
        # the target -> source warp z-buffers the selected rays among
        # themselves: computed in full on every rank of a split
        _, _, rgb_t2s, depth_t2s, inds_src = forward_warp(
            sel, target["rgb"].reshape(cfg.h, cfg.w, 3),
            target["depth"].reshape(cfg.h, cfg.w), k_tar, e_tar, k_sv, e_sv,
            src2tar=False)
        rgb_s2t, depth_s2t, rgb_t2s, depth_t2s = map(
            localize, (rgb_s2t, depth_s2t, rgb_t2s, depth_t2s))
        top = ret["outputs_fine"] or ret["outputs_coarse"]
        rgb_tar = (top["rgb"] if cfg.perturb_camera_no_detach
                   else top["rgb"].detach())
        cc = (cfg.cam_src2tar * L.smooth_l1(rgb_tar, rgb_s2t, rgb_s2t > 0)
              + cfg.cam_tar2src * L.smooth_l1(
                  rgb_src.reshape(-1, 3)[inds_src], rgb_t2s, rgb_t2s > 0))
        return cc + cfg.cam_depth * (
            L.smooth_l1(target["depth"][sel], depth_s2t, depth_s2t > 0)
            + L.smooth_l1(depth_src.reshape(-1)[inds_src], depth_t2s,
                          depth_t2s > 0))

    def compute_losses(delta, rot, trans, target, src, draws, generator):
        """(the enabled loss terms, their sum) at the perturbed sources."""
        src_cams = (transform_src_cameras(src["cameras"], rot, trans)
                    if cfg.perturb_camera else src["cameras"])
        with span("attack.features"):
            perturbed = src["rgbs"] + delta
            # a split runs the feature net on each rank's own views only
            feats = (bundle.extract_features(perturbed) if split is None
                     else split.view_features(bundle.extract_features,
                                              perturbed))
        sel = draws["sel"]
        ret_gt = None
        with span("attack.render"):
            # delta reaches the renderer only through the feature maps: the
            # RGB taps stay on the clean source pixels, as in the reference
            ret = render_at(feats, target["camera"], target, src, src_cams,
                            sel, cfg.w, generator, unit=main_unit,
                            samples=draws["samples"])
            if cfg.use_pseudo_gt:
                with torch.no_grad():
                    ret_gt = render_at(src["featmaps_clean"],
                                       target["camera"], target, src,
                                       src_cams, sel, cfg.w, None, gt_cfg,
                                       unit=main_unit,
                                       samples=draws["samples"])
        with span("attack.loss"):
            return loss_terms(feats, ret, ret_gt, target, src, src_cams,
                              draws, generator)

    def loss_terms(feats, ret, ret_gt, target, src, src_cams, draws,
                   generator):
        """(the enabled loss terms, their sum) of the renders ``ret`` (and
        the pseudo-GT ``ret_gt``, or None)."""
        sel = draws["sel"]
        if ret_gt is not None:
            top_gt = ret_gt["outputs_fine"] or ret_gt["outputs_coarse"]
            gt_rgb, gt_depth = top_gt["rgb"], top_gt["depth"]
        else:
            gt_rgb = target["rgb"][sel]
            gt_depth = (target["depth"][sel]
                        if target.get("depth") is not None else None)

        # inserted in JAX's order, which is the order of the sum
        terms = {"rgb": L.both_levels(lambda o: L.rgb_criterion(o, gt_rgb),
                                      ret)}
        if cfg.density_loss > 0:
            terms["density"] = cfg.density_loss * L.both_levels(
                L.density_loss, ret, ret_gt)
        if cfg.depth_var_loss > 0:
            terms["depth_var"] = cfg.depth_var_loss * L.both_levels(
                L.depth_var_loss, ret)
        if cfg.depth_diff_loss > 0:
            terms["depth_diff"] = cfg.depth_diff_loss * L.both_levels(
                lambda o: L.depth_diff_loss(o, gt_depth), ret)
        if cfg.depth_consistency_loss > 0:
            terms["depth_cons"] = cfg.depth_consistency_loss * \
                depth_consistency(feats, ret, target, src, src_cams, draws,
                                  generator)
        if cfg.depth_smooth_loss > 0:
            # a dedicated patch batch with the same perturbed features when
            # the main batch is not patch-sampled
            if cfg.use_patch_sampling:
                ret_smooth = ret
            else:
                with span("attack.render"):
                    ret_smooth = render_at(
                        feats, target["camera"], target, src, src_cams,
                        draws["sel_patch"], cfg.w, generator,
                        unit=patch_unit)
            terms["depth_smooth"] = cfg.depth_smooth_loss * L.both_levels(
                lambda o: L.depth_smooth_loss(o["depth"], cfg.patch_size),
                ret_smooth)
        if cfg.camera_consistency_loss > 0:
            terms["camera_cons"] = cfg.camera_consistency_loss * \
                camera_consistency(ret, target, src, src_cams, draws)
        return terms, sum(terms.values())

    def draw(generator, device, n_src, sel, sel_patch, depth_src_id,
             camera_src_id, sel_half, samples):
        """The step's random draws, each taken from ``generator`` unless the
        caller gave it."""
        if sel is None:
            sel = select_ray_indices(generator, cfg, device)
        if samples is None:  # the main render's and its pseudo-GT's
            samples = render_draws(generator, gt_cfg, sel.shape[0],
                                   torch.float32, device)["samples"]
        if (sel_patch is None and cfg.depth_smooth_loss > 0
                and not cfg.use_patch_sampling):
            sel_patch = select_ray_indices(
                generator, dataclasses.replace(cfg, use_patch_sampling=True),
                device)
        draws = {"sel": sel, "sel_patch": sel_patch, "samples": samples}
        if cfg.depth_consistency_loss > 0:
            draws["depth_src_id"] = draw_view(generator, n_src, device,
                                              depth_src_id)
            if cfg.ds_rgb and sel_half is None:
                # the main batch's sampling mode at the reduced resolution
                sel_half = select_ray_indices(generator, dataclasses.replace(
                    cfg, h=int(cfg.h * cfg.resize_factor),
                    w=int(cfg.w * cfg.resize_factor)), device)
            draws["sel_half"] = sel_half
        if cfg.camera_consistency_loss > 0:
            draws["camera_src_id"] = draw_view(generator, n_src, device,
                                               camera_src_id)
        return draws

    def step(state, target, src, generator=None, sel=None, sel_patch=None,
             pc_order=None, depth_src_id=None, camera_src_id=None,
             sel_half=None, samples=None):
        with span("attack.step", counters=True):
            with span("attack.draw"):
                draws = draw(generator, src["rgbs"].device,
                             src["rgbs"].shape[0], sel, sel_patch,
                             depth_src_id, camera_src_id, sel_half, samples)
            return step_on(state, target, src, generator, draws, pc_order)

    def step_on(state, target, src, generator, draws, pc_order):
        names = ("delta", "rot", "trans") if cfg.perturb_camera else ("delta",)
        params = [state[n].detach().requires_grad_(True) for n in names]
        live = dict(state, **dict(zip(names, params)))
        with _frozen(modules), torch.enable_grad():
            terms, loss = compute_losses(live["delta"], live["rot"],
                                         live["trans"], target, src, draws,
                                         generator)
            with span("attack.backward"):
                grads = gradients(terms, loss, params, pc_order, generator)
        if cfg.perturb_camera_no_opt:
            grads = grads[:1] + [torch.zeros_like(g) for g in grads[1:]]
        with span("attack.update"):
            new = update(state, names, params, grads, src)
        aux = {"loss": loss.detach(),
               **{k: t.detach() for k, t in terms.items()}}
        return new, aux

    def gradients(terms, loss, params, pc_order, generator):
        """The ascent gradients of ``params``: of the summed loss, or
        through PCGrad's surgery; summed over a split's ranks."""
        def grads_of(out, retain=False):
            """d out / d params, zeros where a parameter is unused."""
            gs = torch.autograd.grad(out, params, retain_graph=retain,
                                     allow_unused=True)
            return [torch.zeros_like(p) if g is None else g
                    for g, p in zip(gs, params)]

        if cfg.use_pcgrad:
            # one backward per loss term over the shared graph: surgery
            # on delta's gradients, the sum for the camera parameters;
            # a split sums each term's gradients over the ranks first
            per_loss = [grads_of(terms[n], retain=True)
                        for n in loss_names]
            if split is not None:
                flat = split.all_reduce([g for gs in per_loss for g in gs])
                per_loss = [flat[i:i + len(params)]
                            for i in range(0, len(flat), len(params))]
            grads = [pcgrad_combine(
                torch.stack([gs[0] for gs in per_loss]),
                major_idx=major_idx, order=pc_order, generator=generator)]
            grads += [sum(gs[i] for gs in per_loss)
                      for i in range(1, len(params))]
        else:
            grads = grads_of(loss)
            if split is not None:
                grads = split.all_reduce(grads)
        return grads

    def update(state, names, params, grads, src):
        """Adam or the sign step, the projection, the camera clamps."""
        new = dict(state, step=state["step"] + 1)
        for name, p, g in zip(names, params, grads):
            p = p.detach()
            key = "" if name == "delta" else "_" + name
            if cfg.use_adam:
                new[name], new["m" + key], new["v" + key] = adam_update(
                    p, -g, state["m" + key], state["v" + key], state["step"],
                    adam_lr(cfg, state["step"]))
            elif name == "delta":
                new[name] = p + cfg.alpha * torch.sign(g)
            elif not cfg.perturb_camera_no_opt:
                new[name] = p + cfg.adv_lr * torch.sign(g)
        new["delta"] = project_delta(new["delta"], src["rgbs"], cfg.eps)
        if cfg.perturb_camera:
            new["rot"] = clamp(new["rot"], -cfg.rot_eps_rad, cfg.rot_eps_rad)
            new["trans"] = clamp(new["trans"], -cfg.trans_epsilon,
                                 cfg.trans_epsilon)
        return new

    return step
