"""PCGrad gradient surgery over the per-source-view slices of ``delta``
(port of ``nerfool_tpu/attack/pcgrad.py``).

Each of the V source views' slices is a parameter. For each view the K
per-loss gradients are flattened and conflicting components removed
pairwise: ``g_i`` loses its component along ``g_j`` when ``g_i . g_j < 0``,
either against every task in turn (in ``order``; the reference shuffles the
tasks, here the caller gives a permutation or a ``torch.Generator`` to draw
one, else the order is 0..K-1) or only against a designated major loss. The
projected gradients are then summed.
"""
from __future__ import annotations

import torch


def pcgrad_combine(task_grads, major_idx=None, order=None, generator=None):
    """Combine K per-loss gradients into one, per source view.

    :param task_grads: [K, V, ...] per-loss gradients of delta
    :param major_idx: optional index of the major loss
    :param order: optional [K] permutation, the order in which each task is
        projected against the others
    :param generator: ``torch.Generator`` on ``task_grads``' device that
        draws ``order`` when none is given
    :return: combined gradient [V, ...]
    """
    k, v = task_grads.shape[:2]
    flat = task_grads.reshape(k, v, -1)
    dot = lambda a, b: torch.sum(a * b, dim=-1, keepdim=True)
    if major_idx is not None:
        g_major = flat[major_idx]
        d = dot(flat, g_major[None])  # [K, V, 1]
        proj = torch.where(
            d < 0, flat - d * g_major[None] / (dot(g_major, g_major) + 1e-6),
            flat)
        proj[major_idx] = g_major
        return torch.sum(proj, dim=0).reshape(task_grads.shape[1:])
    if order is None:
        order = (torch.randperm(k, generator=generator,
                                device=task_grads.device)
                 if generator is not None else range(k))
    g = flat.clone()
    for j in (int(i) for i in order):
        g_j = flat[j]  # the other task's gradient as it came in
        d = dot(g, g_j[None])
        g = torch.where(d < 0, g - d * g_j[None] / (dot(g_j, g_j) + 1e-6), g)
    return torch.sum(g, dim=0).reshape(task_grads.shape[1:])
