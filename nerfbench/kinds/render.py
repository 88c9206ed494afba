"""Render traffic: whole frames of the test views in turn, each from its
own sources' features, through ``Evaluator.render_view`` under
``torch.inference_mode`` as ``Evaluator.evaluate`` renders them. Set-up
warms the feature net at the sources' size and one render chunk of every
size a frame uses. The window keeps each frame's rgb and depth (and, with
a fine level, the coarse compositing weights); after it a sample of every
frame's pixels, drawn from the benchmark's stream, is rendered again by the
reference, whose fine level is drawn both from its own coarse weights and
from the program's.
"""
from __future__ import annotations

import torch

from nerfbench import compare, program
from nerfbench.reference import precision
from nerfbench.reference.render import rays_at
from nerfbench.session import Session


class RenderSession(Session):
    unit = "frame"

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.stride = int(self.ev.args.render_stride)
        self.chunk = int(self.ev.args.chunk_size)
        self.hs = len(range(0, self.rig.h, self.stride))
        self.ws = len(range(0, self.rig.w, self.stride))
        self.srcs = [self.ev._make_src(v) for v in self.rig.views]
        self.phase("sources")
        self.frames = []
        self.warm()
        self.phase("warm-up")

    @property
    def n_rays(self):
        return self.hs * self.ws

    def chunk_sizes(self):
        n, c = self.n_rays, self.chunk
        return [min(c, n - i) for i in range(0, n, c)]

    def warm(self):
        """The feature net at the sources' size and one chunk of each size
        the frames use, through the port's own ray renderer."""
        from nerfool_tpu_torch.render.render_rays import render_rays as port
        from nerfool_tpu_torch.utils.cameras import get_rays

        ev, view, src = self.ev, self.rig.views[0], self.srcs[0]
        cam = torch.as_tensor(view["camera"], device=self.device)
        rays_o, rays_d = get_rays(self.rig.h, self.rig.w,
                                  cam[2:18].reshape(4, 4),
                                  cam[18:34].reshape(4, 4),
                                  render_stride=self.stride)
        rcfg = ev.view_render_cfg(int(src["cameras"].shape[0]))
        with torch.inference_mode():
            feats = ev.bundle.extract_features(src["rgbs"])
            for n in sorted(set(self.chunk_sizes())):
                batch = {"ray_o": rays_o[:n], "ray_d": rays_d[:n],
                         "depth_range": torch.as_tensor(
                             view["depth_range"], device=self.device
                         ).reshape(1, 2), "camera": cam[None]}
                port(ev.bundle.nets, batch, feats, rcfg, src["rgbs"],
                     src["cameras"])
        self.sync()

    def unit_of_work(self, i):
        k = i % len(self.rig.views)
        with torch.inference_mode():
            ret = self.ev.render_view(self.rig.views[k], self.srcs[k])
            fine = ret["outputs_fine"] is not None
            keep = {"outputs_coarse": ("rgb", "depth") + ("weights",) * fine,
                    "outputs_fine": ("rgb", "depth")}
            self.frames.append((k, {
                level[len("outputs_"):]: {q: ret[level][q].reshape(
                    (self.n_rays, -1) if q != "depth" else (self.n_rays,))
                    for q in keep[level]}
                for level in keep if ret[level] is not None}))

    def end_to_end(self, window_s, ms):
        return {"render_rays_per_s": len(ms) * self.n_rays / window_s}

    def traced_context(self, trace, units):
        return self.traced(trace, units, self.n_rays, self.chunk_sizes())

    def picks(self):
        """Each kept frame's compared pixels: ``check_pixels`` distinct ray
        indices of the frame, drawn after the window."""
        n = min(int(self.cell.traffic["check_pixels"]), self.n_rays)
        out = []
        for _ in self.frames:
            scores = torch.rand(self.n_rays, generator=self.draws,
                                device=self.device)
            out.append(torch.topk(scores, n).indices)
        return out

    def program_readings(self):
        self.picked = self.picks()
        rows = [{lv: {q: x[pick] for q, x in out.items()}
                 for lv, out in frame.items()}
                for (_, frame), pick in zip(self.frames, self.picked)]
        return _cat(rows)

    def drop(self):
        self.srcs = None
        self.frames = [(k, None) for k, _ in self.frames]

    def reference_readings(self, tf32=False, given=None, feature_batches=1):
        """The reference at the compared pixels of every kept frame, in the
        layout of ``program_readings``; ``tf32``: on the TF32 tensor cores
        (the control); ``given``: the judged side's readings in that layout,
        handed to the backbone's render chunk by chunk (a fine level
        ``fine_given_coarse`` is drawn from their coarse weights);
        ``feature_batches``: its feature net in that many batches
        of views (a second f32 rounding of the reference itself)."""
        feature_net, model = program.reference_model(
            self.cell.config, self.cell.traffic, self.state_dicts)
        backbone = model["backbone"]
        feature_net = self.in_batches(feature_net, feature_batches)
        feats, rows = {}, []
        with precision(tf32), torch.no_grad():
            for j, ((k, _), pick) in enumerate(zip(self.frames, self.picked)):
                view = self.view_tensors(self.rig.views[k])
                if k not in feats:
                    feats[k] = feature_net(view["src_rgbs"])
                # a strided frame's ray (r, c) is the pixel (r, c) x stride
                full = ((pick // self.ws) * self.stride * self.rig.w
                        + (pick % self.ws) * self.stride)
                parts, base = [], j * len(pick)
                for i in range(0, len(pick), self.chunk):
                    rays = full[i:i + self.chunk]
                    rays_o, rays_d = rays_at(rays, view["camera"])
                    at = slice(base + i, base + i + len(rays))
                    part = None if given is None else {
                        lv: {q: x[at] for q, x in o.items()}
                        for lv, o in given.items()}
                    ret = backbone.render_rays(
                        model, rays_o, rays_d, view["camera"],
                        view["depth_range"], feats[k], view["src_rgbs"],
                        view["src_cameras"], given=part)
                    ret["coarse"]["rgb"] = backbone.frame_rgb(ret["coarse"])
                    # the coarse weights too where a fine level is drawn
                    keep = {"coarse": ("rgb", "depth") + ("weights",) * (
                        ret["fine"] is not None)}
                    parts.append({lv: {q: o[q] for q in keep.get(
                        lv, ("rgb", "depth"))}
                        for lv, o in ret.items() if o is not None})
                rows.append(_cat(parts))
        return _cat(rows)

    numbers = staticmethod(compare.render_numbers)

    def judge(self, readings, **kw):
        return self.numbers(readings,
                            self.reference_readings(given=readings, **kw))


def _cat(rows):
    return {lv: {q: torch.cat([r[lv][q] for r in rows])
                 for q in rows[0][lv]} for lv in rows[0]}


SESSION = RenderSession
