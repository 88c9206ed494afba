"""The system under test, built from a configuration file and a traffic
mix: the port's flags, its model bundle with the benchmark's weights, and
its ``Evaluator``. Also the reference modules with the same weights.
Nothing of the port is imported until a function here runs.
"""
from __future__ import annotations

import json

import torch

from nerfbench import backbones
from nerfbench.weights import seeded_state_dicts


def argv_of(flags):
    """Command-line words of a flag dict: ``True`` is a bare switch,
    ``False`` leaves it out, a dict is JSON, anything else its text."""
    argv = []
    for key, value in flags.items():
        if value is True:
            argv.append(f"--{key}")
        elif value is False:
            continue
        else:
            text = json.dumps(value) if isinstance(value, dict) else str(value)
            argv += [f"--{key}", text]
    return argv


def flags_of(config, traffic):
    return {**config["flags"], **traffic.get("flags", {})}


def port_args(config, traffic):
    """The port's parsed flags for this cell."""
    from nerfool_tpu_torch.config import port_parser

    args = port_parser().parse_args(argv_of(flags_of(config, traffic)))
    args.distributed = False
    return args


def reference_modules(config, traffic, device="meta"):
    """{'feature_net', 'net_coarse'[, 'net_fine']}: the reference modules
    of the configuration's backbone, with the port's parameter names."""
    f = flags_of(config, traffic)
    with torch.device(device):
        return backbones.of(f).modules(f)


def weights(config, traffic, seed, device):
    """The cell's seeded weights as state dicts on ``device``."""
    return seeded_state_dicts(reference_modules(config, traffic), seed, device)


def build_evaluator(config, traffic, state_dicts, seed, device):
    """The port's ``Evaluator`` over a model bundle that holds
    ``state_dicts``. Its own test split (``dataset_kwargs``: a stand-in the
    benchmark never renders) is built because the constructor needs one;
    the benchmark hands its views to the evaluator's methods."""
    from nerfool_tpu_torch.engine import Evaluator
    from nerfool_tpu_torch.models.bundle import create_model

    args = port_args(config, traffic)
    bundle = create_model(args=args, state_dicts=state_dicts, device=device)
    return Evaluator(args, bundle=bundle, dataset_kwargs=args.dataset_kwargs,
                     device=device, seed=seed)


def reference_model(config, traffic, state_dicts):
    """(feature net, render model dict) of the reference, its parameters
    and buffers the tensors of ``state_dicts``; the dict's ``'backbone'`` is
    the backbone's module, whose ``render_rays`` takes it."""
    f = flags_of(config, traffic)
    backbone = backbones.of(f)
    mods = reference_modules(config, traffic)
    for name, module in mods.items():
        module.load_state_dict(state_dicts[name], assign=True)
        module.eval().requires_grad_(False)
    return mods["feature_net"], {**backbone.model(f, mods),
                                 "backbone": backbone}
