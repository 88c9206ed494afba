"""Purification defenses (port of ``nerfool_tpu/attack/purify.py``).

A defensive perturbation ``purif`` is minimized with Adam (plain descent)
on top of the frozen attack ``delta``, under a self-purification objective
(one perturbed source view re-rendered as the target and pulled toward its
own perturbed pixels) and/or a multi-view-consistency objective (the render
pulled toward a perturbed source view warped through its ground-truth
depth), then clamped to its eps-ball and the image box; the caller adds it
to ``delta``. With neither objective the loss is empty and ``purif`` keeps
its random start (JAX's step fails there: it differentiates an integer 0).
The random-noise defense adds Gaussian noise to ``delta``.

The step is an eager function over a small state dict (``purif``, its Adam
moments, the step count). The caller may pass the ray indices and the two
source views; otherwise they are drawn from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses

import torch

from nerfool_tpu_torch.attack import losses as L
from nerfool_tpu_torch.attack.attack import (
    AttackConfig,
    _frozen,
    adam_lr,
    adam_update,
    draw_view,
    select_ray_indices,
)
from nerfool_tpu_torch.attack.perturb import clamp
from nerfool_tpu_torch.attack.warp import forward_warp
from nerfool_tpu_torch.render.render_rays import RenderConfig, render_rays
from nerfool_tpu_torch.utils.cameras import get_rays_at


@dataclasses.dataclass(frozen=True)
class PurifyConfig:
    h: int
    w: int
    purif_epsilon: float = 8.0  # /255
    purif_iters: int = 100
    adam_lr: float = 1e-3
    lr_step_size: int = 100
    lr_gamma: float = 0.5
    n_rand: int = 512
    sample_mode: str = "uniform"
    center_ratio: float = 0.8
    use_patch_sampling: bool = False
    patch_size: int = 8
    use_self_purification: bool = True
    purif_consistency_loss: float = 0.0

    @property
    def eps(self):
        return self.purif_epsilon / 255.0


def make_purify_step(bundle, render_cfg: RenderConfig, cfg: PurifyConfig):
    """(init_state, step) of the purification for ``bundle``, whose
    parameters are frozen while a step runs.

    init_state(generator, src_rgbs, delta, purif=None) -> state
      ``purif`` uniform in its eps-ball unless given, clamped to the box
    step(state, target, src, delta, generator=None, sel=None, view_id=None,
         cons_id=None) -> (state, aux)
      target: the current train view ({'camera', 'rgb', 'depth_range'});
        under self-purification the render's camera and ground truth are a
        perturbed source view's instead
      src: the clean sources ({'rgbs', 'cameras', 'depths'})
      delta: the frozen attack perturbation
      sel: ray indices; view_id: the self-purified source view; cons_id:
        the source view the consistency term warps; each drawn from
        ``generator`` when None
      aux: {'loss', plus one entry per term}, detached
    """
    modules = (bundle.feature_net, bundle.net_coarse, bundle.net_fine)
    render_cfg = dataclasses.replace(render_cfg, bspg_specs=None,
                                     use_clean_color=False,
                                     use_clean_density=False)
    sel_cfg = AttackConfig(
        h=cfg.h, w=cfg.w, n_rand=cfg.n_rand, sample_mode=cfg.sample_mode,
        center_ratio=cfg.center_ratio,
        use_patch_sampling=cfg.use_patch_sampling, patch_size=cfg.patch_size)

    def init_state(generator, src_rgbs, delta, purif=None):
        if purif is None:
            u = torch.rand(src_rgbs.shape, dtype=src_rgbs.dtype,
                           device=src_rgbs.device, generator=generator)
            purif = (2.0 * u - 1.0) * cfg.eps
        base = src_rgbs + delta
        purif = clamp(purif.to(src_rgbs), -base, 1.0 - base)
        return {"purif": purif, "m": torch.zeros_like(purif),
                "v": torch.zeros_like(purif), "step": 0}

    def losses(purif, target, src, delta, sel, view_id, cons_id, generator):
        if not (cfg.use_self_purification or cfg.purif_consistency_loss > 0):
            return {}
        perturbed = src["rgbs"] + delta
        if cfg.use_self_purification:
            cam = src["cameras"][view_id][0]
        else:
            cam = target["camera"]
        intr, c2w = cam[2:18].reshape(4, 4), cam[18:34].reshape(4, 4)
        rays_o, rays_d = get_rays_at(sel, cfg.w, intr, c2w)
        batch = {"ray_o": rays_o, "ray_d": rays_d,
                 "depth_range": target["depth_range"], "camera": cam[None]}
        ret = render_rays(bundle.nets, batch,
                          bundle.extract_features(perturbed + purif),
                          render_cfg, src["rgbs"], src["cameras"],
                          generator=generator)

        def both_levels(fn):
            total = fn(ret["outputs_coarse"])
            if ret["outputs_fine"] is not None:
                total = total + fn(ret["outputs_fine"])
            return total

        terms = {}
        if cfg.use_self_purification:
            gt = perturbed[view_id][0].reshape(-1, 3)[sel]
            terms["rgb"] = both_levels(lambda o: L.rgb_criterion(o, gt))
        if cfg.purif_consistency_loss > 0:
            s_cam = src["cameras"][cons_id][0]
            rgb_warped = forward_warp(
                sel, perturbed[cons_id][0], src["depths"][cons_id][0],
                s_cam[2:18].reshape(4, 4)[:3, :3], s_cam[18:34].reshape(4, 4),
                intr[:3, :3], c2w, src2tar=True)[2]
            terms["camera_cons"] = cfg.purif_consistency_loss * both_levels(
                lambda o: L.smooth_l1(o["rgb"], rgb_warped, rgb_warped > 0))
        return terms

    def step(state, target, src, delta, generator=None, sel=None,
             view_id=None, cons_id=None):
        device = src["rgbs"].device
        n_src = src["rgbs"].shape[0]
        if sel is None:
            sel = select_ray_indices(generator, sel_cfg, device)
        view_id = draw_view(generator, n_src, device, view_id)
        cons_id = draw_view(generator, n_src, device, cons_id)
        purif = state["purif"].detach().requires_grad_(True)
        with _frozen(modules), torch.enable_grad():
            terms = losses(purif, target, src, delta, sel, view_id, cons_id,
                           generator)
            loss = sum(terms.values(), purif.new_zeros(()))
            grad = (torch.autograd.grad(loss, [purif])[0] if terms
                    else torch.zeros_like(purif))
        new, m, v = adam_update(purif.detach(), grad, state["m"], state["v"],
                                state["step"], adam_lr(cfg, state["step"]))
        new = clamp(new, -cfg.eps, cfg.eps)
        base = src["rgbs"] + delta
        new = clamp(new, -base, 1.0 - base)
        aux = {"loss": loss.detach(),
               **{k: t.detach() for k, t in terms.items()}}
        return {"purif": new, "m": m, "v": v, "step": state["step"] + 1}, aux

    return init_state, step


def apply_random_noise_defense(generator, delta, noise_std_255: float):
    """``--def_random_noise``: Gaussian noise of std ``noise_std_255`` / 255
    added to the perturbation."""
    return delta + torch.randn(delta.shape, dtype=delta.dtype,
                               device=delta.device, generator=generator) * (
        noise_std_255 / 255.0)
