"""L-inf perturbation state: init and projection (port of
``nerfool_tpu/attack/perturb.py``). ``delta`` is uniform in the eps-ball and,
after every step, projected into the eps-ball intersected with the [0, 1]
image box around the clean sources.
"""
from __future__ import annotations

import torch


def clamp(x, lower, upper):
    """Elementwise clamp with tensor or scalar bounds, in ``x``'s dtype (a
    Python float bound is not rounded to float32 first)."""
    as_x = lambda b: torch.as_tensor(b, dtype=x.dtype, device=x.device)
    return torch.maximum(torch.minimum(x, as_x(upper)), as_x(lower))


def init_delta(generator, src_rgbs, epsilon, lower=0.0, upper=1.0):
    """:param generator: a ``torch.Generator`` on ``src_rgbs``'s device
    :param src_rgbs: [V, H, W, 3] clean sources in [0, 1]
    :param epsilon: scalar L-inf budget (already /255-scaled)
    :return: delta [V, H, W, 3]
    """
    u = torch.rand(src_rgbs.shape, dtype=src_rgbs.dtype,
                   device=src_rgbs.device, generator=generator)
    delta = (2.0 * u - 1.0) * epsilon
    return clamp(delta, lower - src_rgbs, upper - src_rgbs)


def project_delta(delta, src_rgbs, epsilon, lower=0.0, upper=1.0):
    """Project into the eps-ball intersected with the image box."""
    delta = clamp(delta, -epsilon, epsilon)
    return clamp(delta, lower - src_rgbs, upper - src_rgbs)
