"""The attack step: one gradient-ascent update on the source-view
perturbation ``delta`` (port of ``nerfool_tpu/attack/attack.py``).

One iteration selects a random ray subset of the target view, re-extracts
the features of the perturbed sources, renders the subset, sums the enabled
loss terms, differentiates to ``delta``, and applies the Adam or sign-PGD
update followed by the eps-ball / image-box projection. Gradient ascent is
expressed as the reference does it: negate the gradient and feed a standard
descending optimizer.

The step is an eager function over a small state dict (``delta``, the Adam
moments, the step count). The caller may pass the ray indices ``sel`` (and
``sel_patch``, the dedicated depth-smooth patch batch) and the initial
``delta``; otherwise they are drawn from an explicit ``torch.Generator``.
The aggregators' and the feature net's parameters are frozen
(``requires_grad=False``) while a step runs, and only then: only ``delta``
is differentiated, and a trainer sharing the models finds their flags as it
left them.

Not ported, and raising ``NotImplementedError`` by flag name: gradient
surgery (``use_pcgrad``), the camera-pose attack (``perturb_camera*``) and
the warp losses (``depth_consistency_loss``, ``camera_consistency_loss``,
``ds_rgb``).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from nerfool_tpu_torch.attack import losses as L
from nerfool_tpu_torch.attack.perturb import init_delta, project_delta
from nerfool_tpu_torch.render.render_rays import RenderConfig, render_rays
from nerfool_tpu_torch.utils.cameras import get_rays_at


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
    use_pcgrad: bool = False
    perturb_camera: bool = False
    perturb_camera_no_opt: bool = False

    @property
    def eps(self):
        return self.epsilon / 255.0

    @property
    def alpha(self):
        return self.adv_lr / 255.0

    def enabled_losses(self):
        names = ["rgb"]
        for name in ("density", "depth_var", "depth_diff", "depth_smooth"):
            if getattr(self, f"{name}_loss") > 0:
                names.append(name)
        return names

    def unported(self):
        """Names of the set flags this package does not implement."""
        return [name for name in (
            "use_pcgrad", "perturb_camera", "perturb_camera_no_opt",
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


def init_attack_state(generator, cfg: AttackConfig, src_rgbs, delta=None):
    """The attack state: ``delta`` (drawn uniformly in the eps-ball from
    ``generator`` unless given), zero Adam moments, step 0."""
    if delta is None:
        delta = init_delta(generator, src_rgbs, cfg.eps)
    delta = delta.detach().to(src_rgbs)
    return {"delta": delta, "m": torch.zeros_like(delta),
            "v": torch.zeros_like(delta), "step": 0}


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
    while a step runs (only ``delta`` is differentiated) and get their
    ``requires_grad`` flags back when it returns.

    step(state, target, src, generator=None, sel=None, sel_patch=None)
        -> (state, aux)
      target: {'camera' [34], 'rgb' [H*W, 3] or None, 'depth' [H*W] or None,
               'depth_range' [1, 2]}
      src:    {'rgbs' [V, Hs, Ws, 3], 'cameras' [V, 34],
               'featmaps_clean': (coarse, fine) or None}
      sel, sel_patch: ray indices of the main batch and of the dedicated
        depth-smooth patch batch; drawn from ``generator`` when None
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

    def render_subset(feats, target, src, sel):
        cam = target["camera"]
        rays_o, rays_d = get_rays_at(sel, cfg.w, cam[2:18].reshape(4, 4),
                                     cam[18:34].reshape(4, 4))
        batch = {"ray_o": rays_o, "ray_d": rays_d,
                 "depth_range": target["depth_range"], "camera": cam[None]}
        return render_rays(nets, batch, feats, render_cfg, src["rgbs"],
                           src["cameras"])

    def both_levels(fn, ret, *others):
        """fn summed over the coarse and (when rendered) fine outputs."""
        total = fn(ret["outputs_coarse"],
                   *(o["outputs_coarse"] for o in others))
        if ret["outputs_fine"] is not None:
            total = total + fn(ret["outputs_fine"],
                               *(o["outputs_fine"] for o in others))
        return total

    def compute_losses(delta, target, src, sel, sel_patch):
        feats = bundle.extract_features(src["rgbs"] + delta)
        # delta reaches the renderer only through the feature maps: the RGB
        # taps stay on the clean source pixels, as in the reference
        ret = render_subset(feats, target, src, sel)

        if cfg.use_pseudo_gt:
            with torch.no_grad():
                ret_gt = render_subset(src["featmaps_clean"], target, src, sel)
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
            ret_smooth = (ret if cfg.use_patch_sampling
                          else render_subset(feats, target, src, sel_patch))
            terms["depth_smooth"] = cfg.depth_smooth_loss * both_levels(
                lambda o: L.depth_smooth_loss(o["depth"], cfg.patch_size),
                ret_smooth)
        return terms

    def step(state, target, src, generator=None, sel=None, sel_patch=None):
        device = src["rgbs"].device
        if sel is None:
            sel = select_ray_indices(generator, cfg, device)
        if (sel_patch is None and cfg.depth_smooth_loss > 0
                and not cfg.use_patch_sampling):
            sel_patch = select_ray_indices(
                generator, dataclasses.replace(cfg, use_patch_sampling=True),
                device)
        delta = state["delta"].detach().requires_grad_(True)
        with _frozen(modules), torch.enable_grad():
            terms = compute_losses(delta, target, src, sel, sel_patch)
            loss = sum(terms.values())
            grad, = torch.autograd.grad(loss, delta)
        delta = delta.detach()
        m, v = state["m"], state["v"]
        if cfg.use_adam:
            delta, m, v = adam_update(delta, -grad, m, v, state["step"],
                                      adam_lr(cfg, state["step"]))
        else:
            delta = delta + cfg.alpha * torch.sign(grad)
        delta = project_delta(delta, src["rgbs"], cfg.eps)
        aux = {"loss": loss.detach(),
               **{k: t.detach() for k, t in terms.items()}}
        return ({"delta": delta, "m": m, "v": v, "step": state["step"] + 1},
                aux)

    return step
