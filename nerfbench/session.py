"""What every cell's run builds first: the scene, the weights, the port's
evaluator, and the benchmark's own random stream for its draws."""
from __future__ import annotations

import dataclasses
import gc
import time

import torch

from nerfbench import program
from nerfbench.scene import Rig


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    scene: dict
    limits: dict

    @property
    def flags(self):
        return program.flags_of(self.config, self.traffic)


@dataclasses.dataclass
class Traced:
    """What the per-layer readers read: the trace, the units of work in it
    (attack iterations or frames), and the cell's shapes."""
    trace: object
    units: int
    flags: dict
    rays_per_unit: int
    chunks: tuple  # the ray counts of a unit's render chunks
    feature_hw: tuple  # the source images' height and width
    n_views: int


class Session:
    unit = None  # "iteration" or "frame"

    def __init__(self, cell, seed, device):
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.phases = {}  # set-up seconds by phase, each ending synchronized
        self.mark = time.perf_counter()
        self.rig = Rig(cell.scene, self.seed, self.device)
        self.phase("scene")
        self.state_dicts = program.weights(cell.config, cell.traffic,
                                           self.seed, self.device)
        self.phase("weights")
        self.ev = program.build_evaluator(cell.config, cell.traffic,
                                          self.state_dicts, self.seed,
                                          self.device)
        self.phase("evaluator")
        self.draws = torch.Generator(device=self.device).manual_seed(
            (self.seed + 1_000_003) % 2 ** 63)

    def phase(self, name):
        """Close the set-up phase ``name``."""
        self.sync()
        now = time.perf_counter()
        self.phases[name] = now - self.mark
        self.mark = now

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def free_program(self):
        """Drop every object of the program, so that the reference runs on
        a card that holds only the benchmark's inputs."""
        self.ev = None
        self.drop()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def drop(self):
        """Drop the kind's own references to the program's state."""

    def judge(self, readings, **kw):
        """The compared numbers of ``readings`` (the program's, or another's
        put in its place) against the reference on the same inputs; ``kw``
        goes to the reference."""
        return self.numbers(readings, self.reference_readings(**kw))

    @staticmethod
    def in_batches(net, batches):
        """``net`` run on the source views in ``batches`` batches: another
        rounding of the same function (cuDNN picks per batch size)."""
        if batches == 1:
            return net

        def run(x):
            outs = [net(part) for part in torch.chunk(x, batches)]
            return tuple(torch.cat(o) for o in zip(*outs))

        return run

    def view_tensors(self, view):
        """A rig view's inputs on the device, for the reference."""
        t = lambda x: torch.as_tensor(x, device=self.device)
        return {"src_rgbs": t(view["src_rgbs"]),
                "src_cameras": t(view["src_cameras"]),
                "camera": t(view["camera"]),
                "rgb": t(view["rgb"]).reshape(-1, 3),
                "depth_range": t(view["depth_range"])}

    def traced(self, trace, units, rays_per_unit, chunks):
        return Traced(trace, units, self.cell.flags,
                      rays_per_unit, tuple(chunks),
                      (self.rig.h, self.rig.w), self.rig.n_src)
