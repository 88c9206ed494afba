"""Attack traffic: the view-specific attack on one test view, iteration
after iteration, as ``Evaluator.attack_view_specific`` builds and drives
the step (``make_attack_step`` over the evaluator's bundle and its
differentiated render config, the view's target and sources, the attack
state). The benchmark draws each iteration's rays (``N_rand`` distinct
pixels) and the perturbation's start from its own stream and hands them to
the step, so that the reference gets the same.

Set-up drives the step through its first ``steps_checked`` iterations (the
warm-up of every shape the window uses); the reference follows those
steps. The window then goes on from that state. The first of them also
keeps the output of the program's coarse aggregator (``net_coarse``, read
by a forward hook that is gone before the window), and the reference its
own: the first step's inputs are the same on both sides, so the two are
compared sample by sample, below the fine level's resampling.
"""
from __future__ import annotations

import contextlib

import torch

from nerfbench import compare, program
from nerfbench.reference import attack as ref_attack
from nerfbench.reference import precision
from nerfbench.session import Session


@contextlib.contextmanager
def first_output(module):
    """Inside the block, the list holds ``module``'s first output (a
    tensor, detached and copied) once it has been called; with no module,
    nothing."""
    seen = []
    if module is None:
        yield seen
        return

    def keep(mod, args, out):
        if not seen and torch.is_tensor(out):
            seen.append(out.detach().clone())

    handle = module.register_forward_hook(keep)
    try:
        yield seen
    finally:
        handle.remove()


class AttackSession(Session):
    unit = "iteration"

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        from nerfool_tpu_torch.attack.attack import (init_attack_state,
                                                     make_attack_step)
        from nerfool_tpu_torch.engine import build_attack_config

        t = cell.traffic
        ev = self.ev
        self.view = self.rig.views[int(t["view"])]
        self.target, (h, w) = ev._make_target(self.view)
        self.cfg = build_attack_config(ev.args, h, w)
        self.step = make_attack_step(ev.bundle, ev._grad_render_cfg(),
                                     self.cfg, split=ev.split)
        self.src = ev._make_src(self.view, clean_feats=self.cfg.use_pseudo_gt)
        self.phase("step and sources")
        rgbs = self.src["rgbs"]
        u = torch.rand(rgbs.shape, generator=self.draws, device=self.device)
        eps = self.cfg.eps
        self.delta0 = torch.maximum(torch.minimum((2 * u - 1) * eps,
                                                  1.0 - rgbs), -rgbs)
        self.state = init_attack_state(ev.generator, self.cfg, rgbs,
                                       self.delta0)
        self.sels, self.losses = [], []
        for i in range(int(t["steps_checked"])):
            if i == 0:
                with first_output(ev.bundle.net_coarse) as seen:
                    self.unit_of_work(i)
                self.coarse_net = seen[0] if seen else None
            else:
                self.unit_of_work(i)
            self.losses.append(self.aux["loss"])
            if i == 0:
                # Adam's first moment after one step is (1 - b1) times the
                # gradient of the descended objective, -loss
                self.grad1 = -self.state["m"] / (1.0 - 0.9)
        self.delta_end = self.state["delta"]
        self.phase("checked steps")

    def draw_rays(self):
        h, w = self.cfg.h, self.cfg.w
        scores = torch.rand(h * w, generator=self.draws, device=self.device)
        return torch.topk(scores, self.cfg.n_rand).indices

    def unit_of_work(self, i):
        sel = self.draw_rays()
        if len(self.sels) < int(self.cell.traffic["steps_checked"]):
            self.sels.append(sel)
        self.state, self.aux = self.step(self.state, self.target, self.src,
                                         sel=sel)

    def end_to_end(self, window_s, ms):
        # p90: the highest round percentile with ten iterations beyond it
        # in a 51 s window of the slower attack (~120 iterations)
        ordered = sorted(ms)
        p90 = ordered[min(len(ordered) - 1, int(0.9 * (len(ordered) - 1) + 0.5))]
        return {"attack_ms_per_iter": 1e3 * window_s / len(ms),
                "attack_iter_ms_p90": p90}

    def traced_context(self, trace, units):
        return self.traced(trace, units, self.cfg.n_rand, ())

    def program_readings(self):
        return {"loss": torch.stack(self.losses), "grad": self.grad1,
                "delta0": self.delta0, "delta": self.delta_end,
                "coarse_net": self.coarse_net}

    def drop(self):
        self.step = self.state = self.aux = self.src = self.target = None
        self.coarse_net = None

    def reference_readings(self, tf32=False, feature_batches=1):
        """The reference's steps; ``tf32``: on the TF32 tensor cores (the
        control); ``feature_batches``: its feature net in that many batches
        of views (a second f32 rounding of the reference itself)."""
        feature_net, model = program.reference_model(
            self.cell.config, self.cell.traffic, self.state_dicts)
        view = self.view_tensors(self.view)
        with precision(tf32), first_output(model.get("net_coarse")) as seen:
            out = ref_attack.attack_steps(
                model, self.in_batches(feature_net, feature_batches), view,
                self.delta0, self.sels,
                lr=float(self.cfg.adam_lr), eps=self.cfg.eps)
        return {"loss": out["loss"], "grad": out["grad"],
                "delta0": self.delta0, "delta": out["delta"][-1],
                "coarse_net": seen[0] if seen else None}

    numbers = staticmethod(compare.attack_numbers)


SESSION = AttackSession
