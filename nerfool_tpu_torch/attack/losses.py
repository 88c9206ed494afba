"""Attack loss terms, pure functions over renderer outputs (port of
``nerfool_tpu/attack/losses.py``). The attack maximizes these, so the sign
flip lives in the optimizer, not here.
"""
from __future__ import annotations

import torch

TINY = 1e-6


def both_levels(fn, ret, *others):
    """``fn`` summed over the coarse and (when rendered) fine outputs of
    ``ret``, with those of ``others`` at the same level."""
    total = fn(ret["outputs_coarse"], *(o["outputs_coarse"] for o in others))
    if ret["outputs_fine"] is not None:
        total = total + fn(ret["outputs_fine"],
                           *(o["outputs_fine"] for o in others))
    return total


def masked_mse(pred, gt, mask=None):
    """Plain mean, or mask-weighted mean over the last axis size."""
    if mask is None:
        return torch.mean((pred - gt) ** 2)
    num = torch.sum((pred - gt) ** 2 * mask[..., None])
    den = torch.sum(mask) * pred.shape[-1] + TINY
    return num / den


def rgb_criterion(outputs, gt_rgb):
    """Masked MSE with the renderer's validity mask when present (ibrnet),
    plain mean otherwise (gnt)."""
    mask = outputs.get("mask")
    if mask is None:
        return masked_mse(outputs["rgb"], gt_rgb)
    return masked_mse(outputs["rgb"], gt_rgb, mask.to(outputs["rgb"].dtype))


def smooth_l1(pred, gt, mask):
    """SmoothL1(beta=1) mean over mask; matches nn.SmoothL1Loss on
    pred[mask]."""
    diff = pred - gt
    a = torch.abs(diff)
    loss = torch.where(a < 1.0, 0.5 * diff * diff, a - 0.5)
    mask = mask.to(loss.dtype)
    return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1.0)


def depth_diff_loss(outputs, depth_gt):
    """SmoothL1 between predicted and GT depth on gt>0 pixels."""
    return smooth_l1(outputs["depth"], depth_gt, depth_gt > 0)


def depth_var_loss(outputs):
    """Per-ray depth variance under compositing weights, mean over valid rays
    (rays with a zero weight sum are dropped)."""
    w = outputs["weights"]
    z = outputs["z_vals"]
    d = outputs["depth"]
    wsum = torch.sum(w, dim=1)
    var = torch.sum(w * (z - d[:, None]) ** 2, dim=1) / torch.where(
        wsum == 0, torch.ones_like(wsum), wsum)
    valid = wsum != 0
    return torch.sum(torch.where(valid, var, torch.zeros_like(var))) / \
        torch.clamp(torch.sum(valid), min=1)


def depth_smooth_loss(depth, patch_size, loss_type="l2"):
    """RegNeRF-style patch smoothness on depth of patch-sampled rays.

    :param depth: [n_patches * patch_size**2] (patch-major ray order)
    """
    d = depth.reshape(-1, patch_size, patch_size)
    v00 = d[:, :-1, :-1]
    v01 = d[:, :-1, 1:]
    v10 = d[:, 1:, :-1]
    if loss_type == "l2":
        loss = (v00 - v01) ** 2 + (v00 - v10) ** 2
    elif loss_type == "l1":
        loss = torch.abs(v00 - v01) + torch.abs(v00 - v10)
    else:
        raise ValueError(loss_type)
    return torch.sum(loss)


def density_loss(outputs, outputs_gt):
    """MSE between attacked and clean per-sample alphas (needs pseudo-GT)."""
    return masked_mse(outputs["alpha"], outputs_gt["alpha"])
