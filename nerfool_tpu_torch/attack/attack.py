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

The step is an eager function over a small state dict (``delta``, ``rot``,
``trans``, their Adam moments, the step count). The caller may pass the ray
indices ``sel`` (and ``sel_patch``, the dedicated depth-smooth patch batch),
the PCGrad task order and the initial values; otherwise they are drawn from
an explicit ``torch.Generator``. The aggregators' and the feature net's
parameters are frozen (``requires_grad=False``) while a step runs, and only
then: a trainer sharing the models finds their flags as it left them.

Not ported, and raising ``NotImplementedError`` by flag name: the warp
losses (``depth_consistency_loss``, ``camera_consistency_loss``,
``ds_rgb``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from nerfool_tpu_torch.attack import losses as L
from nerfool_tpu_torch.attack.pcgrad import pcgrad_combine
from nerfool_tpu_torch.attack.perturb import clamp, init_delta, project_delta
from nerfool_tpu_torch.render.render_rays import RenderConfig, render_rays
from nerfool_tpu_torch.utils.cameras import get_rays_at, transform_src_cameras


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
    # parsed, not ported: a non-default value raises in make_attack_step
    depth_consistency_loss: float = 0.0
    ds_rgb: bool = False
    camera_consistency_loss: float = 0.0
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
        names = ["rgb"]
        for name in ("density", "depth_var", "depth_diff", "depth_smooth"):
            if getattr(self, f"{name}_loss") > 0:
                names.append(name)
        return names

    def unported(self):
        """Names of the set flags this package does not implement."""
        return [name for name in (
            "depth_consistency_loss", "camera_consistency_loss", "ds_rgb")
            if getattr(self, name)]


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


def make_attack_step(bundle, render_cfg: RenderConfig, cfg: AttackConfig):
    """Build the attack step for ``bundle``. Its parameters are frozen
    while a step runs (only ``delta`` and the camera parameters are
    differentiated) and get their ``requires_grad`` flags back when it
    returns.

    step(state, target, src, generator=None, sel=None, sel_patch=None,
         pc_order=None) -> (state, aux)
      target: {'camera' [34], 'rgb' [H*W, 3] or None, 'depth' [H*W] or None,
               'depth_range' [1, 2]}
      src:    {'rgbs' [V, Hs, Ws, 3], 'cameras' [V, 34],
               'featmaps_clean': (coarse, fine) or None}
      sel, sel_patch: ray indices of the main batch and of the dedicated
        depth-smooth patch batch; drawn from ``generator`` when None
      pc_order: with ``use_pcgrad`` and no major loss, the order in which
        each loss's gradient is projected against the others; drawn from
        ``generator`` when None
      aux: {'loss': total, plus one entry per enabled term}, detached
    """
    unported = cfg.unported()
    if unported:
        raise NotImplementedError(
            "not ported to nerfool_tpu_torch: "
            + ", ".join(f"--{name}" for name in unported))
    if cfg.density_loss > 0 and not cfg.use_pseudo_gt:
        raise ValueError("--density_loss requires --use_pseudo_gt")
    modules = (bundle.feature_net, bundle.net_coarse, bundle.net_fine)
    nets = bundle.nets
    # the attack samples random pixels: per-tap gather, never the block plan
    render_cfg = dataclasses.replace(render_cfg, bspg_specs=None)

    loss_names = cfg.enabled_losses()
    major_idx = (loss_names.index(cfg.major_loss)
                 if cfg.major_loss in loss_names else None)

    def render_subset(feats, target, src, src_cams, sel):
        cam = target["camera"]
        rays_o, rays_d = get_rays_at(sel, cfg.w, cam[2:18].reshape(4, 4),
                                     cam[18:34].reshape(4, 4))
        batch = {"ray_o": rays_o, "ray_d": rays_d,
                 "depth_range": target["depth_range"], "camera": cam[None]}
        return render_rays(nets, batch, feats, render_cfg, src["rgbs"],
                           src_cams)

    def both_levels(fn, ret, *others):
        """fn summed over the coarse and (when rendered) fine outputs."""
        total = fn(ret["outputs_coarse"],
                   *(o["outputs_coarse"] for o in others))
        if ret["outputs_fine"] is not None:
            total = total + fn(ret["outputs_fine"],
                               *(o["outputs_fine"] for o in others))
        return total

    def compute_losses(delta, rot, trans, target, src, sel, sel_patch):
        src_cams = (transform_src_cameras(src["cameras"], rot, trans)
                    if cfg.perturb_camera else src["cameras"])
        feats = bundle.extract_features(src["rgbs"] + delta)
        # delta reaches the renderer only through the feature maps: the RGB
        # taps stay on the clean source pixels, as in the reference
        ret = render_subset(feats, target, src, src_cams, sel)

        if cfg.use_pseudo_gt:
            with torch.no_grad():
                ret_gt = render_subset(src["featmaps_clean"], target, src,
                                       src_cams, sel)
            top_gt = ret_gt["outputs_fine"] or ret_gt["outputs_coarse"]
            gt_rgb, gt_depth = top_gt["rgb"], top_gt["depth"]
        else:
            ret_gt = None
            gt_rgb = target["rgb"][sel]
            gt_depth = (target["depth"][sel]
                        if target.get("depth") is not None else None)

        terms = {"rgb": both_levels(lambda o: L.rgb_criterion(o, gt_rgb), ret)}
        if cfg.density_loss > 0:
            terms["density"] = cfg.density_loss * both_levels(
                L.density_loss, ret, ret_gt)
        if cfg.depth_var_loss > 0:
            terms["depth_var"] = cfg.depth_var_loss * both_levels(
                L.depth_var_loss, ret)
        if cfg.depth_diff_loss > 0:
            terms["depth_diff"] = cfg.depth_diff_loss * both_levels(
                lambda o: L.depth_diff_loss(o, gt_depth), ret)
        if cfg.depth_smooth_loss > 0:
            # a dedicated patch batch with the same perturbed features when
            # the main batch is not patch-sampled
            ret_smooth = (ret if cfg.use_patch_sampling else render_subset(
                feats, target, src, src_cams, sel_patch))
            terms["depth_smooth"] = cfg.depth_smooth_loss * both_levels(
                lambda o: L.depth_smooth_loss(o["depth"], cfg.patch_size),
                ret_smooth)
        return terms

    def step(state, target, src, generator=None, sel=None, sel_patch=None,
             pc_order=None):
        device = src["rgbs"].device
        if sel is None:
            sel = select_ray_indices(generator, cfg, device)
        if (sel_patch is None and cfg.depth_smooth_loss > 0
                and not cfg.use_patch_sampling):
            sel_patch = select_ray_indices(
                generator, dataclasses.replace(cfg, use_patch_sampling=True),
                device)
        names = ("delta", "rot", "trans") if cfg.perturb_camera else ("delta",)
        params = [state[n].detach().requires_grad_(True) for n in names]
        live = dict(state, **dict(zip(names, params)))
        def grads_of(out, retain=False):
            """d out / d params, zeros where a parameter is unused."""
            gs = torch.autograd.grad(out, params, retain_graph=retain,
                                     allow_unused=True)
            return [torch.zeros_like(p) if g is None else g
                    for g, p in zip(gs, params)]

        with _frozen(modules), torch.enable_grad():
            terms = compute_losses(live["delta"], live["rot"], live["trans"],
                                   target, src, sel, sel_patch)
            loss = sum(terms.values())
            if cfg.use_pcgrad:
                # one backward per loss term over the shared graph: surgery
                # on delta's gradients, the sum for the camera parameters
                per_loss = [grads_of(terms[n], retain=True)
                            for n in loss_names]
                grads = [pcgrad_combine(
                    torch.stack([gs[0] for gs in per_loss]),
                    major_idx=major_idx, order=pc_order, generator=generator)]
                grads += [sum(gs[i] for gs in per_loss)
                          for i in range(1, len(params))]
            else:
                grads = grads_of(loss)
        if cfg.perturb_camera_no_opt:
            grads = grads[:1] + [torch.zeros_like(g) for g in grads[1:]]

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
        aux = {"loss": loss.detach(),
               **{k: t.detach() for k, t in terms.items()}}
        return new, aux

    return step
