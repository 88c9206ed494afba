"""One module per backbone, the only place that knows what it needs,
reached through ``of(name)``; below it ``models/`` and the render
primitives import none of it. Each module has: ``FLAGS`` (its own flags
``build`` reads), ``build``, ``checkpoint_state``, ``render_config``
(``use``: 'frame', 'attack', 'train' or None; refuses what it cannot
render), ``draw_shapes``, ``render_rays``, and its protocol: ``psnr``,
``ssim``, ``LPIPS_NORMALIZE``, ``LR_FLAG`` (the aggregators' learning
rate), ``PAINT_EMPTY_COARSE`` and ``PER_TAP`` (why no BSPG plan serves its
frames, or None).
"""
from __future__ import annotations

import importlib

NAMES = ("ibrnet", "gnt", "pixelnerf")


def keep(x, *_):
    """``checkpoint_state`` or ``render_config`` that changes nothing."""
    return x


def of(name):
    """The module of backbone ``name``."""
    if name not in NAMES:
        raise ValueError(f"unknown backbone {name!r}")
    return importlib.import_module(f"{__name__}.{name}")
