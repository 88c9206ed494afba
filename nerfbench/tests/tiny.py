"""The benchmark's cells cut to a size the CPU tests can hold: a 48x64 rig
of 12 views with 4 sources, few samples, two GNT blocks, small ray
batches. Everything else (the traffic, the kinds, the readers, the
comparison) is the cells' own."""
from __future__ import annotations

import copy

from nerfbench import run

SCENE = {"h": 48, "w": 64, "n_views": 12, "llffhold": 4, "n_src": 4,
         "focal": 815.1, "focal_width": 1008, "grid": [3, 4],
         "baseline": [0.8, 0.5], "depth_range": [1.2, 21.3], "layers": 4}


def tiny_cell(name, limits=None):
    cell = run.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.scene = dict(SCENE)
    f = cell.config["flags"]
    f.update(num_source_views=4)
    if f["backbone"] == "gnt":
        f.update(N_samples=16, trans_depth=2, N_rand=64, chunk_size=512)
    else:
        f.update(N_samples=12, N_importance=8, N_rand=64, chunk_size=1024)
    cell.traffic["check_pixels"] = 256
    if limits is not None:
        cell.limits = {"checks": {k: {"limit": v} for k, v in limits.items()}}
    return cell
