"""Seeded random weights, made on the device in one draw.

PyTorch's default initialisation of a ``Linear`` or ``Conv2d``: weights and
biases uniform in +-1/sqrt(fan_in). Every other parameter keeps the value
its module gives it (norm scales 1 and shifts 0, IBRNet's anti-alias ``s``
0.2), and so does every persistent buffer (a BatchNorm's running mean 0,
variance 1 and batch count 0), for which nothing is drawn. The shapes come
from the reference modules, whose parameter names are the port's (the
published checkpoints' layout), so one state dict loads into both.
"""
from __future__ import annotations

import math

import torch


def seeded_state_dicts(modules, seed, device):
    """:param modules: {name: reference module} (any device, ``meta`` too)
    :return: {name: state dict on ``device``}, the same for the same seed
    """
    plan = []
    for mname, module in modules.items():
        params = dict(module.named_parameters())
        for pname, p in params.items():
            owner, _, leaf = pname.rpartition(".")
            weight = params.get(f"{owner}.weight" if owner else "weight")
            if weight is not None and weight.dim() >= 2:
                bound = 1.0 / math.sqrt(weight[0].numel())
                plan.append((mname, pname, tuple(p.shape), bound))
            else:
                plan.append((mname, pname, tuple(p.shape), None))
    drawn = sum(math.prod(s) for _, _, s, b in plan if b is not None)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    u = torch.rand(drawn, generator=gen, device=device)
    out = {name: {} for name in modules}
    at = 0
    for mname, pname, shape, bound in plan:
        if bound is None:
            src = dict(modules[mname].named_parameters())[pname]
            value = (src.detach().to(device) if src.device.type != "meta"
                     else _default(pname, shape, device))
        else:
            n = math.prod(shape)
            value = ((2.0 * u[at:at + n] - 1.0) * bound).reshape(shape)
            at += n
        out[mname][pname] = value
    for mname, module in modules.items():
        params = dict(module.named_parameters())
        for bname, b in module.state_dict(keep_vars=True).items():
            if bname not in params:
                out[mname][bname] = (
                    b.detach().to(device) if b.device.type != "meta"
                    else _default(bname, tuple(b.shape), device, b.dtype))
    return out


def _default(name, shape, device, dtype=torch.float32):
    """The module default of a parameter or persistent buffer created on the
    ``meta`` device."""
    if name == "s":
        return torch.full(shape, 0.2, device=device, dtype=dtype)
    fill = 1 if name.endswith(("weight", "running_var")) else 0
    return torch.full(shape, fill, device=device, dtype=dtype)
