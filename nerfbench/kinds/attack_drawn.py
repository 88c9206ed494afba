"""Attack traffic of a backbone whose sampler draws at random: the
view-specific attack of ``kinds/attack.py``, and each iteration also
draws, from the benchmark's own stream after its rays, the sampler's draws
of those rays (the backbone's ``draw_shapes``: uniform or standard normal
tensors). It hands them to the program's step (``samples=``) and the same
draws of the checked steps to the reference's steps (as the render model's
``draws``, one tuple a step), so that both sides sample the same depths.
Everything else is the attack kind's: set-up, the window, the traced
readings, the comparison.
"""
from __future__ import annotations

import torch

from nerfbench import backbones, program
from nerfbench.kinds.attack import AttackSession, first_output
from nerfbench.reference import attack as ref_attack
from nerfbench.reference import precision


class DrawnAttackSession(AttackSession):
    def __init__(self, cell, seed, device):
        self.samples = []
        super().__init__(cell, seed, device)

    def draw_samples(self, n_rays):
        f = self.cell.flags
        return tuple(
            (torch.rand if how == "uniform" else torch.randn)(
                shape, generator=self.draws, device=self.device)
            for shape, how in backbones.of(f).draw_shapes(f, n_rays))

    def unit_of_work(self, i):
        sel = self.draw_rays()
        samples = self.draw_samples(len(sel))
        if len(self.sels) < int(self.cell.traffic["steps_checked"]):
            self.sels.append(sel)
            self.samples.append(samples)
        self.state, self.aux = self.step(self.state, self.target, self.src,
                                         sel=sel, samples=samples)

    def reference_readings(self, tf32=False, feature_batches=1):
        """The reference's steps on the same rays and draws (a step over
        fewer rays, as the half-batch fault plants, takes the draws of
        those rays)."""
        feature_net, model = program.reference_model(
            self.cell.config, self.cell.traffic, self.state_dicts)
        model["draws"] = iter([tuple(x[:len(sel)] for x in samples)
                               for sel, samples in zip(self.sels,
                                                       self.samples)])
        view = self.view_tensors(self.view)
        with precision(tf32), first_output(model.get("net_coarse")) as seen:
            out = ref_attack.attack_steps(
                model, self.in_batches(feature_net, feature_batches), view,
                self.delta0, self.sels,
                lr=float(self.cfg.adam_lr), eps=self.cfg.eps)
        return {"loss": out["loss"], "grad": out["grad"],
                "delta0": self.delta0, "delta": out["delta"][-1],
                "coarse_net": seen[0] if seen else None}


SESSION = DrawnAttackSession
