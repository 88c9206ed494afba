"""The backbones the benchmark knows, one module each, found by the
configuration's ``backbone`` flag: ``nerfbench/backbones/<backbone>.py``.
Nothing else of the harness names a backbone. A module gives:

- ``modules(flags)``: the reference modules ``{'feature_net',
  'net_coarse'[, 'net_fine']}`` with the port's parameter names, built on
  the device the caller has set;
- ``model(flags, mods)``: the render model dict that ``render_rays`` takes
  (the harness adds ``'backbone'``: this module); where it holds
  ``'net_coarse'``, the attack compares that module's first output with
  the program's coarse aggregator's;
- ``render_rays(model, rays_o, rays_d, camera, depth_range, feats,
  src_rgbs, src_cameras, given=None)``: every level of a batch of rays,
  ``{'coarse': {...}, 'fine': {...} or None[, 'fine_given_coarse': {...}]}``,
  built from the helpers of ``nerfbench/reference/render.py``; ``given``:
  the judged side's readings of these rays (``{level: {quantity:
  tensor}}``), from which a level may take what the program drew;
- ``frame_rgb(coarse)``: the coarse rgb as the evaluator leaves it in a
  frame;
- ``feature_flops(flags, n_views, h, w)`` and ``aggregator_flops(flags,
  n_views, rays, backward)``: the model's operations from the shapes
  (``nerfbench/counts/``), which the ``mfu.*`` readers use;
- ``tiny(flags)``: the flags the CPU tests change, cut to a size they hold.
"""
from __future__ import annotations

import importlib


def of(flags):
    """The module of the backbone that ``flags`` name."""
    return importlib.import_module(f"nerfbench.backbones.{flags['backbone']}")


def sampled_model(flags, mods):
    """The render model of a backbone that samples as
    ``reference.render.two_levels`` does."""
    return {"n_samples": int(flags["N_samples"]),
            "n_importance": int(flags.get("N_importance", 64)),
            "inv_uniform": bool(flags.get("inv_uniform", False)),
            "net_coarse": mods["net_coarse"],
            "net_fine": mods.get("net_fine", mods["net_coarse"])}


def feature_dims(flags):
    """(coarse, fine) feature channels of the ResUNet."""
    return (int(flags.get("coarse_feat_dim", 32)),
            int(flags.get("fine_feat_dim", 32)))
