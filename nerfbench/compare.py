"""The numbers that decide ``correct``: what the program produced against
what the reference produced from the same inputs.

Attack cells (a step with optimizer state, read as training is): each
step's loss, the first step's gradient as the optimizer got it, and the
perturbation's change over the steps, each gradient and change taken by
its worst leaf (a leaf is one source view's perturbation) as the gap
between the program's norm and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf (and, as steadier
readings, by the median leaf). Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of the change (they move by round-off alone). Where both sides kept
the coarse aggregator's output of the first step (``coarse_net``), the
median and the mean of its absolute differences, sample by sample: the
same inputs on both sides, ahead of the fine level's resampling, whose
jumps set the floor of the other numbers. Outputs of different shapes
read infinite.

Render cells: the absolute differences of rgb and depth at the compared
pixels, per level, summarised by their median, mean, 99.9th percentile
and maximum. The reference's level ``fine_given_coarse`` (its fine level
drawn from the judged side's coarse weights) is held against the judged
side's fine level.
"""
from __future__ import annotations

import torch


def _leaf_gaps(prog, ref, keep=None):
    """(|prog norm - ref norm|) / max(ref norm, median ref norm) of each
    leaf (the leading axis) that ``keep`` keeps."""
    p = torch.linalg.vector_norm(prog.double().flatten(1), dim=1)
    r = torch.linalg.vector_norm(ref.double().flatten(1), dim=1)
    scale = torch.maximum(r, torch.median(r))
    gap = torch.abs(p - r) / scale
    return gap if keep is None else gap[keep]


def attack_numbers(prog, ref, floor=1e-3):
    """:param prog, ref: {'loss' [n], 'grad' [V, ...] (the first step's),
        'delta0', 'delta' [V, ...] (the start and after the n steps)}"""
    loss_p, loss_r = prog["loss"].double(), ref["loss"].double()
    loss_gap = torch.abs(loss_p - loss_r) / torch.abs(loss_r)
    g_ref = torch.linalg.vector_norm(ref["grad"].double().flatten(1), dim=1)
    keep = g_ref >= floor * torch.median(g_ref)
    grad = _leaf_gaps(prog["grad"], ref["grad"])
    change = _leaf_gaps(prog["delta"] - prog["delta0"],
                        ref["delta"] - ref["delta0"], keep)
    out = {
        **{f"loss_step{i + 1}": float(x) for i, x in enumerate(loss_gap)},
        "loss": float(torch.max(loss_gap)),
        "grad_norm": float(torch.max(grad)),
        "grad_norm_median": float(torch.median(grad)),
        "change_norm": float(torch.max(change)) if change.numel() else 0.0,
        "change_norm_median": (float(torch.median(change))
                               if change.numel() else 0.0),
    }
    net_p, net_r = prog.get("coarse_net"), ref.get("coarse_net")
    if net_p is not None and net_r is not None:
        if net_p.shape == net_r.shape:
            d = torch.abs(net_p.double() - net_r.double()).flatten()
            out["coarse_net_median"] = _quantile(d, 0.5)
            out["coarse_net_mean"] = float(torch.mean(d))
        else:
            out["coarse_net_median"] = out["coarse_net_mean"] = float("inf")
    return out


def _quantile(x, q):
    s = torch.sort(x).values
    return float(s[min(len(s) - 1, int(q * (len(s) - 1) + 0.5))])


# the judged side's level that a reference level is held against
JUDGED_LEVEL = {"fine_given_coarse": "fine"}


def render_numbers(prog, ref):
    """:param prog, ref: {level: {'rgb' [N, 3], 'depth' [N]}} at the same
    pixels
    :return: {'<quantity>_<stat>.<level>': value} for each level of ref"""
    out = {}
    for level, r in ref.items():
        p = prog[JUDGED_LEVEL.get(level, level)]
        for q in ("rgb", "depth"):
            d = torch.abs(p[q].double() - r[q].double()).flatten()
            out[f"{q}_median.{level}"] = _quantile(d, 0.5)
            out[f"{q}_mean.{level}"] = float(torch.mean(d))
            out[f"{q}_p999.{level}"] = _quantile(d, 0.999)
            out[f"{q}_max.{level}"] = float(torch.max(d))
    return out
