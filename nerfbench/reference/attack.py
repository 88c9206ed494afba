"""Plain view-specific attack steps (NeRFool, Fu et al., ICML 2023),
frozen here as the benchmark's reference: render the chosen rays from the
features of the perturbed sources (the colour taps stay on the clean
sources), the colour loss on both levels (IBRNet's masked by its ray mask,
GNT's a plain mean), its gradient to the perturbation, an ascending Adam
step, and the projection into the eps-ball inside the image box.
"""
from __future__ import annotations

import torch

from nerfbench.reference.render import rays_at


def colour_loss(out, gt):
    err = (out["rgb"] - gt) ** 2
    mask = out.get("mask")
    if mask is None:
        return torch.mean(err)
    m = mask.to(err.dtype)
    return torch.sum(err * m[:, None]) / (torch.sum(m) * 3 + 1e-6)


def attack_steps(model, feature_net, view, delta, sels, lr, eps,
                 b1=0.9, b2=0.999, adam_eps=1e-8):
    """Run ``len(sels)`` steps from ``delta``.

    :param view: {'src_rgbs' [V, H, W, 3], 'src_cameras' [V, 34],
        'camera' [34], 'rgb' [H*W, 3], 'depth_range' [2]} on the device
    :return: {'loss': [n] losses, 'grad': the first step's gradient,
        'delta': [n + 1] perturbations (the start, then after each step)}
    """
    src = view["src_rgbs"]
    m = torch.zeros_like(delta)
    v = torch.zeros_like(delta)
    losses, deltas, first_grad = [], [delta], None
    for t, sel in enumerate(sels):
        d = delta.detach().requires_grad_(True)
        feats = feature_net(src + d)
        rays_o, rays_d = rays_at(sel, view["camera"])
        ret = model["backbone"].render_rays(
            model, rays_o, rays_d, view["camera"], view["depth_range"],
            feats, src, view["src_cameras"])
        gt = view["rgb"][sel]
        loss = colour_loss(ret["coarse"], gt)
        if ret["fine"] is not None:
            loss = loss + colour_loss(ret["fine"], gt)
        (g,) = torch.autograd.grad(loss, [d])
        if first_grad is None:
            first_grad = g
        m = b1 * m - (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        step = (m / (1 - b1 ** (t + 1))) / (
            torch.sqrt(v / (1 - b2 ** (t + 1))) + adam_eps)
        delta = delta - lr * step
        delta = torch.clamp(delta, -eps, eps)
        delta = torch.maximum(torch.minimum(delta, 1.0 - src), -src)
        losses.append(loss.detach())
        deltas.append(delta)
    return {"loss": torch.stack(losses), "grad": first_grad,
            "delta": deltas}
