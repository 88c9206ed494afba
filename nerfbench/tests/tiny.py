"""The benchmark's cells cut to a size the CPU tests can hold: a 48x64 rig
of 12 views with 4 sources, and each backbone's own cut (its ``tiny``:
few samples, two GNT blocks, small ray batches). Everything else (the
traffic, the kinds, the readers, the comparison) is the cells' own."""
from __future__ import annotations

import copy
import types

import torch

from nerfbench import backbones, program, run
from nerfbench.kinds.attack import AttackSession
from nerfbench.kinds.render import RenderSession
from nerfbench.reference.render import rays_at
from nerfbench.scene import Rig

CPU = torch.device("cpu")

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
    f.update(backbones.of(f).tiny(f))
    cell.traffic["check_pixels"] = 256
    if limits is not None:
        cell.limits = {"checks": {k: {"limit": v} for k, v in limits.items()}}
    return cell


def reference_readings(cell, seed):
    """The reference's readings of ``cell`` through its kind's own
    ``reference_readings``, on inputs drawn from ``seed``, with nothing of
    the program built."""
    make = (attack_readings if cell.traffic["kind"] == "attack"
            else render_readings)
    return make(cell, seed)


def bare(kind, cell, seed):
    """A session of ``kind`` holding only what its reference reads."""
    s = object.__new__(kind)
    s.cell, s.device = cell, CPU
    s.state_dicts = program.weights(cell.config, cell.traffic, seed, CPU)
    s.rig = Rig(cell.scene, seed, CPU)
    return s, torch.Generator().manual_seed(seed)


def attack_readings(cell, seed):
    s, gen = bare(AttackSession, cell, seed)
    f = cell.flags
    s.view = s.rig.views[int(cell.traffic["view"])]
    src = torch.as_tensor(s.view["src_rgbs"])
    eps = float(f["epsilon"]) / 255.0
    u = torch.rand(src.shape, generator=gen)
    s.delta0 = torch.maximum(torch.minimum((2 * u - 1) * eps, 1.0 - src), -src)
    s.sels = [torch.topk(torch.rand(s.rig.h * s.rig.w, generator=gen),
                         int(f["N_rand"])).indices
              for _ in range(int(cell.traffic["steps_checked"]))]
    s.cfg = types.SimpleNamespace(adam_lr=float(f["adam_lr"]), eps=eps)
    out = s.reference_readings()
    return {q: out[q] for q in ("loss", "grad", "delta")}


def render_readings(cell, seed):
    """Every test view a frame of one whole chunk of pixels, as the cells'
    32,768 pixels a frame are 8 chunks; the given coarse weights are drawn
    from the seed, so that the fine level drawn from them differs from the
    reference's own."""
    s, gen = bare(RenderSession, cell, seed)
    f = cell.flags
    s.stride = int(f.get("render_stride", 1))
    s.chunk = int(f["chunk_size"])
    s.hs = len(range(0, s.rig.h, s.stride))
    s.ws = len(range(0, s.rig.w, s.stride))
    n = min(s.chunk, s.hs * s.ws)
    s.frames = [(k, None) for k in range(len(s.rig.views))]
    s.picked = [torch.topk(torch.rand(s.hs * s.ws, generator=gen), n).indices
                for _ in s.frames]
    weights = torch.rand(len(s.frames) * n, int(f["N_samples"]),
                         generator=gen)
    out = s.reference_readings(given={"coarse": {"weights": weights},
                                      "fine": {}})
    return {**{f"{lv}.{q}": x for lv, o in out.items() for q, x in o.items()},
            **ray_readings(s, weights[:n])}


def ray_readings(s, given_weights):
    """One chunk of the first frame's rays through the backbone's render,
    every quantity of every level (the kind keeps fewer)."""
    feature_net, model = program.reference_model(
        s.cell.config, s.cell.traffic, s.state_dicts)
    view = s.view_tensors(s.rig.views[0])
    full = (s.picked[0] // s.ws) * s.stride * s.rig.w + (
        s.picked[0] % s.ws) * s.stride
    rays_o, rays_d = rays_at(full, view["camera"])
    with torch.no_grad():
        ret = model["backbone"].render_rays(
            model, rays_o, rays_d, view["camera"], view["depth_range"],
            feature_net(view["src_rgbs"]), view["src_rgbs"],
            view["src_cameras"], given={"coarse": {"weights": given_weights}})
    return {f"rays.{lv}.{q}": x for lv, o in ret.items() if o is not None
            for q, x in o.items()}
