"""The port's spans (``nerfool_tpu_torch/utils/profiling.py``): free and
shared while no profiler records; under a CPU ``torch.profiler`` nested,
on the profiler's clock, once per phase of the attack step and of the
renderer, written into ``trace()``'s Chrome trace; and the benchmark's
readers of them (``nerfbench/metrics/``) on hand-made records.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from helpers import llff_rig_scene, synthetic_scene

from nerfbench import run
from nerfbench.session import Traced
from nerfbench.trace import Trace
from nerfool_tpu_torch.attack import attack as t_attack
from nerfool_tpu_torch.models.bundle import create_model
from nerfool_tpu_torch.ops import bspg_select
from nerfool_tpu_torch.ops.bspg import plan_render_specs
from nerfool_tpu_torch.render.render_image import render_single_image
from nerfool_tpu_torch.render.render_rays import RenderConfig
from nerfool_tpu_torch.utils import profiling
from nerfool_tpu_torch.utils.cameras import get_rays
from nerfool_tpu_torch.utils.profiling import SpanRecord, span, take_spans

torch.set_num_threads(2)

H, W = 24, 32
MS = 1_000_000  # ns


@pytest.fixture(autouse=True)
def empty_registry():
    """No span of another test's profiled work reaches this one's."""
    take_spans()
    yield
    take_spans()


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_span_is_one_shared_null_context(monkeypatch):
    """Without a profiler: the same object every call, no record, no CUDA
    event and no allocator statistics."""
    def refuse(*a, **k):
        raise AssertionError("called while no profiler records")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "memory_stats", refuse)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    first = span("attack.step", counters=True)
    assert span("render.chunk") is first
    with first, span("render.chunk"):
        pass
    assert take_spans() == []


def test_nesting_and_the_shared_clock():
    """Parents by id, and the host interval of a span holds the profiler's
    own interval of the ``aten::mm`` run inside it."""
    x = torch.randn(64, 64)
    with profiled() as prof:
        with span("outer"):
            with span("inner"):
                x @ x
            with span("second"):
                pass
    recs = {r.name: r for r in take_spans()}
    assert set(recs) == {"outer", "inner", "second"}
    assert recs["outer"].parent is None
    assert recs["inner"].parent == recs["second"].parent == recs["outer"].id
    assert all(r.stream_ms is None for r in recs.values())  # no card
    mm = [(ev.start_ns(), ev.end_ns())
          for ev in prof.profiler.kineto_results.events()
          if ev.name() == "aten::mm"]
    assert len(mm) == 1
    inner = recs["inner"]
    assert inner.begin_ns <= mm[0][0] <= mm[0][1] <= inner.end_ns
    assert recs["outer"].begin_ns <= inner.begin_ns
    assert inner.end_ns <= recs["second"].begin_ns <= recs["outer"].end_ns


def test_counters_and_a_raising_block(monkeypatch):
    """A counting span records the kernel launches made inside it (and no
    allocator keys without a card); a block that raises still ends its
    span, and the next span opens at the top level."""
    monkeypatch.setattr(bspg_select.select_taps, "launches", 5)
    with profiled():
        with span("counted", counters=True):
            bspg_select.select_taps.launches += 2
        with pytest.raises(ValueError):
            with span("raised"):
                raise ValueError
        with span("after"):
            pass
    recs = {r.name: r for r in take_spans()}
    assert recs["counted"].counters == {"launches": 2}
    assert recs["raised"].counters is None
    assert recs["after"].parent is None


def _attack_fixture():
    rng = np.random.RandomState(3)
    target_cam, src_rgbs, src_cams, _, depth_range = synthetic_scene(
        rng, n_src=3, h=H, w=W)
    t = lambda x: torch.as_tensor(np.asarray(x))
    bundle = create_model(backbone="ibrnet", seed=0)
    cfg = t_attack.AttackConfig(h=H, w=W, n_rand=16, use_adam=True,
                                use_pseudo_gt=True)
    src = {"rgbs": t(src_rgbs), "cameras": t(src_cams)}
    with torch.no_grad():
        src["featmaps_clean"] = bundle.extract_features(src["rgbs"])
    target = {"camera": t(target_cam), "rgb": t(rng.rand(H * W, 3)
                                                 .astype(np.float32)),
              "depth": None, "depth_range": t(depth_range)}
    step = t_attack.make_attack_step(
        bundle, RenderConfig(n_samples=12, n_importance=4,
                             backbone="ibrnet"), cfg)
    return step, cfg, target, src


def _attack(step, cfg, target, src, iters):
    state = t_attack.init_attack_state(torch.Generator().manual_seed(0), cfg,
                                       src["rgbs"])
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(iters):
        state, aux = step(state, target, src, generator=gen)
        losses.append(aux["loss"])
    return state, losses


ATTACK_CHILDREN = ["attack.draw", "attack.features", "attack.render",
                   "attack.loss", "attack.backward", "attack.update"]


def test_attack_step_spans_once_per_step_and_same_numbers():
    """Two steps under the profiler: each step one ``attack.step`` with one
    of each phase inside it in order, the renderer's spans inside
    ``attack.render`` (the attacked and the pseudo-GT render); the state
    and losses bit for bit those of the same steps without the profiler."""
    step, cfg, target, src = _attack_fixture()
    plain, plain_losses = _attack(step, cfg, target, src, 2)
    assert take_spans() == []
    with profiled():
        traced, traced_losses = _attack(step, cfg, target, src, 2)
    recs = take_spans()
    for key in ("delta", "m", "v"):
        assert torch.equal(plain[key], traced[key]), key
    assert all(torch.equal(a, b) for a, b in zip(plain_losses,
                                                 traced_losses))
    steps = [r for r in recs if r.name == "attack.step"]
    assert len(steps) == 2
    for s in steps:
        kids = sorted((r for r in recs if r.parent == s.id),
                      key=lambda r: r.begin_ns)
        assert [r.name for r in kids] == ATTACK_CHILDREN
        assert s.counters == {"launches": 0}
        render = kids[2]
        inside = [r for r in recs if r.parent == render.id]
        names = [r.name for r in inside]
        # the attacked render and the pseudo-GT render, two levels each
        assert names.count("render.aggregate.coarse") == 2
        assert names.count("render.fine_sampler") == 2
        assert all(render.begin_ns <= r.begin_ns and r.end_ns <= render.end_ns
                   for r in inside)


def _frame(backbone, bspg):
    rng = np.random.RandomState(11)
    target_cam, src_rgbs, src_cams, _, depth_range = llff_rig_scene(
        rng, n_src=3, h=32, w=32)
    t = lambda x: torch.as_tensor(np.array(x))
    if backbone == "ibrnet":
        bundle = create_model(backbone="ibrnet", seed=0)
        cfg = RenderConfig(n_samples=8, n_importance=4)
    else:
        bundle = create_model(backbone="gnt", trans_depth=2,
                              single_net=True, seed=0)
        cfg = RenderConfig(n_samples=8, backbone="gnt", single_net=True,
                           ret_alpha=True)
    with torch.no_grad():
        feats = bundle.extract_features(t(src_rgbs))
    if bspg:
        cfg = RenderConfig(n_samples=8, n_importance=4, bspg_specs=(
            plan_render_specs(target_cam[None], src_cams,
                              depth_range.reshape(-1), (32, 32),
                              tuple(feats[0].shape[1:3]), block=(4, 4))))
    intr = target_cam[2:18].reshape(4, 4)
    c2w = target_cam[18:34].reshape(4, 4)
    ro, rd = get_rays(32, 32, t(intr), t(c2w))
    batch = {"ray_o": ro, "ray_d": rd, "depth_range": t(depth_range),
             "camera": t(target_cam[None])}
    with torch.no_grad(), profiled():
        out = render_single_image(bundle.nets, batch, feats, cfg, 32, 32,
                                  t(src_rgbs), t(src_cams), chunk_size=384)
    return out, take_spans()


@pytest.mark.parametrize("backbone,bspg,levels", [
    ("ibrnet", False, ("coarse", "fine")),
    ("ibrnet", True, ("coarse", "fine")),
    ("gnt", False, ("coarse",)),
])
def test_render_spans_per_chunk_and_level(backbone, bspg, levels):
    """1024 rays in chunks of 384: three ``render.chunk`` spans, each with
    the gather, aggregate and composite spans of every level (and the fine
    sampler where there is a fine level), then one ``render.assemble``."""
    out, recs = _frame(backbone, bspg)
    assert out["outputs_coarse"]["rgb"].shape == (32, 32, 3)
    chunks = [r for r in recs if r.name == "render.chunk"]
    assert len(chunks) == 3
    assert [r.name for r in recs].count("render.assemble") == 1
    want = sorted(f"render.{part}.{lv}" for lv in levels
                  for part in ("gather", "aggregate", "composite"))
    if len(levels) == 2:
        want = sorted(want + ["render.fine_sampler"])
    for c in chunks:
        assert sorted(r.name for r in recs if r.parent == c.id) == want


def test_trace_writes_the_spans(tmp_path):
    """``trace()`` appends the spans as ``X`` events on a track of their own,
    on the clock of the profiler's events."""
    x = torch.arange(64.0).reshape(8, 8)
    with profiling.trace(str(tmp_path)):
        with span("outer"):
            (x @ x).sum()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "span"]
    assert [e["name"] for e in spans] == ["outer"]
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert len(mm) == 1
    s = spans[0]
    assert s["ts"] <= mm[0]["ts"] + 1  # microseconds, rounded by the export
    assert mm[0]["ts"] + mm[0]["dur"] <= s["ts"] + s["dur"] + 1
    assert take_spans() == []


def test_idle_gaps_by_innermost_span():
    """profile_attack's attribution: each device gap goes to the innermost
    span open on the host when it began."""
    recs = [SpanRecord("step", 0, None, 0, 100), SpanRecord("update", 1, 0,
                                                            60, 90)]
    busy = profiling.merged([(0, 10), (5, 20), (30, 40), (70, 80),
                             (95, 120), (130, 140)])
    assert busy == [[0, 20], [30, 40], [70, 80], [95, 120], [130, 140]]
    idle = profiling.idle_by_span(busy, recs)
    assert idle == {"step": 10 + 30, "update": 15, None: 10}


# (name, start ns, end ns) of host events: three blocking calls inside the
# steps, one outside, one that is no blocking call; a copy operator that
# waits for its copy from pageable memory (inside aten::to), one that
# returns before its copy ends, one that copies on the card
HOST_OPS = [("cudaStreamSynchronize", 10 * MS, 11 * MS),
            ("cudaMemcpyAsync", 26 * MS, 26 * MS + MS // 2),
            ("cudaDeviceSynchronize", 29 * MS, 29 * MS + MS // 2),
            ("cudaStreamSynchronize", 15 * MS, 17 * MS),
            ("aten::mm", 2 * MS, 4 * MS),
            ("aten::to", 21 * MS - 1000, 24 * MS + 1000),
            ("aten::copy_", 21 * MS, 24 * MS),
            ("aten::copy_", 4 * MS, 4 * MS + MS // 10),
            ("aten::copy_", 5 * MS, 6 * MS)]
# (name, start ns, end ns, launching operator) of device activities
DEVICE = [("k", 0, MS, None),
          ("Memcpy HtoD (Pageable -> Device)", 23 * MS, 24 * MS - 100,
           "aten::copy_"),
          ("Memcpy HtoD (Pinned -> Device)", 5 * MS, 6 * MS, "aten::copy_"),
          ("Memcpy DtoD (Device -> Device)", 5 * MS, 5 * MS + MS // 2,
           "aten::copy_")]


def _rec(name, i, parent, begin, end, stream=None, counters=None):
    return SpanRecord(name, i, parent, begin * MS, end * MS, stream, counters)


def _traced(records, host_ops, units, device=DEVICE):
    profiling._done.extend(records)
    return Traced(Trace(0.1, list(device), host_ops), units, {}, 512, (),
                  (756, 1008), 10)


ATTACK = [
    _rec("attack.features", 1, 0, 1, 5, 30.0),
    _rec("attack.render", 2, 0, 5, 8, 10.0),
    _rec("attack.backward", 3, 0, 8, 9, 50.0),
    _rec("attack.step", 0, None, 0, 12, 95.0, {"launches": 0}),
    _rec("attack.features", 5, 4, 21, 25, 32.0),
    _rec("attack.render", 6, 4, 25, 28, 12.0),
    _rec("attack.backward", 7, 4, 28, 29, 54.0),
    _rec("attack.step", 4, None, 20, 30, 99.0, {"launches": 0}),
]
RENDER = [
    _rec("eval.features", 1, 0, 1, 2, 8.0),
    _rec("render.gather.coarse", 3, 2, 2, 3, 4.0),
    _rec("render.aggregate.coarse", 4, 2, 3, 4, 6.0),
    _rec("render.fine_sampler", 5, 2, 4, 5, 1.0),
    _rec("render.gather.fine", 6, 2, 5, 6, 3.0),
    _rec("render.aggregate.fine", 7, 2, 6, 7, 9.0),
    _rec("render.chunk", 2, 0, 2, 8),
    _rec("render.gather.coarse", 9, 8, 8, 9, 4.5),
    _rec("render.aggregate.coarse", 10, 8, 9, 10, 6.5),
    _rec("render.fine_sampler", 11, 8, 10, 11, 1.5),
    _rec("render.chunk", 8, 0, 8, 12),
    _rec("eval.render_view", 0, None, 0, 14, 40.0,
         {"launches": 0, "num_device_alloc": 3, "num_device_free": 1,
          "num_alloc_retries": 0}),
]
# two frames alike
RENDER2 = RENDER + [_rec(r.name, r.id + 100, None if r.parent is None
                         else r.parent + 100, r.begin_ns // MS + 20,
                         r.end_ns // MS + 20, r.stream_ms, r.counters)
                    for r in RENDER]


@pytest.mark.parametrize("metric,records,units,want", [
    ("step_host_ms.attack", ATTACK, 2, (12 + 10) / 2),
    ("step_sync_ms.attack", ATTACK, 2, (1 + 0.5 + 0.5 + 3) / 2),
    ("features_stream_ms.attack", ATTACK, 2, (30 + 32) / 2),
    ("render_stream_ms.attack", ATTACK, 2, (10 + 12) / 2),
    ("backward_stream_ms.attack", ATTACK, 2, (50 + 54) / 2),
    ("features_stream_ms.render", RENDER2, 2, 8.0),
    ("gather_stream_ms.render", RENDER2, 2, 4 + 3 + 4.5),
    ("aggregate_stream_ms.render", RENDER2, 2, 6 + 9 + 6.5),
    ("fine_sampler_stream_ms.render", RENDER2, 2, 1 + 1.5),
    ("chunk_host_ms.render", RENDER2, 2, (6 + 4) / 2),
    ("alloc_calls.render", RENDER2, 2, 3 + 1),
])
def test_span_readers(metric, records, units, want):
    """Each reader on hand-made records: per unit of work (per chunk for
    ``chunk_host_ms``); silent where the spans it reads are absent."""
    t = _traced(records, HOST_OPS, units)
    assert run.reader(metric)(t) == pytest.approx(want)
    # the records are taken once per window and kept for every reader
    assert take_spans() == []
    assert run.reader(metric)(t) == pytest.approx(want)
    other = _traced([_rec("unrelated", 0, None, 0, 1, 1.0)], HOST_OPS, units)
    assert run.reader(metric)(other) is None


def test_span_readers_silent_off_the_card_and_without_spans(monkeypatch):
    """A window with no device activity (a CPU run) and a program without
    ``take_spans`` (an older checkout) give no reading."""
    t = _traced(ATTACK, HOST_OPS, 2, device=())
    assert run.reader("step_host_ms.attack")(t) is None
    assert take_spans() == []
    monkeypatch.delattr(profiling, "take_spans")
    t = _traced(ATTACK, HOST_OPS, 2)
    assert run.reader("step_host_ms.attack")(t) is None
