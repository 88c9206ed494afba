"""The seam of one module per backbone (``nerfool_tpu_torch/backbones/``):
one render's draws come from one function (``render_rays.render_draws``),
so ``render_rays`` drawing from a generator equals ``render_rays`` handed
those draws; the attack step, the train step and a whole frame of every
backbone run through it; pixelNeRF refuses what it cannot render; GNT's
render configs follow their flags per use and device; an unknown backbone
is refused. CPU, tiny widths, seeded random weights.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from helpers import llff_rig_scene

from nerfool_tpu_torch import backbones
from nerfool_tpu_torch.attack.attack import (AttackConfig, init_attack_state,
                                             make_attack_step)
from nerfool_tpu_torch.config import port_parser
from nerfool_tpu_torch.engine import Evaluator, render_config_from_args
from nerfool_tpu_torch.models.bundle import create_model
from nerfool_tpu_torch.render import render_rays as rr
from nerfool_tpu_torch.render.render_image import render_single_image
from nerfool_tpu_torch.train.trainer import TrainConfig, make_train_step
from nerfool_tpu_torch.utils.cameras import get_rays

# the test tier runs several worker processes on a few cores: two math
# threads per process instead of one per core keeps them from thrashing
torch.set_num_threads(2)

H, W, N_SRC = 24, 32, 3
MODEL = {"ibrnet": {}, "gnt": {"trans_depth": 2, "single_net": True},
         "pixelnerf": {"pixelnerf_d_hidden": 32}}
# IBRNet with geo_noise, so that its noise is drawn too
CFG = {"ibrnet": {"geo_noise": 0.1}, "gnt": {"single_net": True},
       "pixelnerf": {"n_depth": 4}}


def _cfg(name, det=True, **kw):
    return rr.RenderConfig(n_samples=10, n_importance=4, det=det,
                           backbone=name, **CFG[name], **kw)


@pytest.fixture(scope="module")
def scene():
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    cam, rgbs, cams, _, depth_range = llff_rig_scene(
        np.random.RandomState(4), n_src=N_SRC, h=H, w=W)
    ro, rd = get_rays(H, W, t(cam)[2:18].reshape(4, 4),
                      t(cam)[18:34].reshape(4, 4))
    return {"camera": t(cam), "src_rgbs": t(rgbs),
            "src_cameras": t(cams).reshape(-1, 34),
            "depth_range": t(depth_range).reshape(1, 2), "ray_o": ro,
            "ray_d": rd, "rgb": torch.rand(H * W, 3, generator=(
                torch.Generator().manual_seed(5)))}


@pytest.fixture(scope="module", params=list(MODEL))
def model(request):
    name = request.param
    return name, create_model(backbone=name, seed=3, **MODEL[name])


def _batch(scene, rows):
    return {"ray_o": scene["ray_o"][rows], "ray_d": scene["ray_d"][rows],
            "depth_range": scene["depth_range"],
            "camera": scene["camera"][None]}


@pytest.mark.parametrize("det", [True, False])
def test_render_rays_draws_what_render_draws_gives(model, scene, det):
    """Bit for bit, and the generator ends in the same state: render_rays
    takes exactly render_draws' draws."""
    name, bundle = model
    cfg = _cfg(name, det)
    batch = _batch(scene, slice(0, 40))
    with torch.no_grad():
        feats = bundle.extract_features(scene["src_rgbs"])
        g1 = torch.Generator().manual_seed(9)
        a = rr.render_rays(bundle.nets, batch, feats, cfg, scene["src_rgbs"],
                           scene["src_cameras"], generator=g1)
        g2 = torch.Generator().manual_seed(9)
        draws = rr.render_draws(g2, cfg, 40, torch.float32, "cpu")
        idle = torch.Generator().manual_seed(0)
        b = rr.render_rays(bundle.nets, batch, feats, cfg, scene["src_rgbs"],
                           scene["src_cameras"], generator=idle, **draws)
    assert torch.equal(g1.get_state(), g2.get_state())
    assert torch.equal(idle.get_state(),
                       torch.Generator().manual_seed(0).get_state())
    drawn = [x for part in draws.values() for x in part or () if x is not None]
    assert drawn or (det and name == "gnt")  # GNT draws nothing then
    for level in ("outputs_coarse", "outputs_fine"):
        assert a[level].keys() == b[level].keys()
        for k in a[level]:
            assert torch.equal(a[level][k], b[level][k]), (level, k)


def _spy(monkeypatch, name):
    """The backbone's ``draw_shapes`` calls, counted: every render_draws
    asks it."""
    bb = backbones.of(name)
    calls = []
    real = bb.draw_shapes
    monkeypatch.setattr(bb, "draw_shapes",
                        lambda *a: (calls.append(a[1]), real(*a))[1])
    return calls


@pytest.mark.parametrize("path", ["attack", "train", "frame"])
def test_each_path_runs_through_the_one_draw_function(model, scene, path,
                                                      monkeypatch):
    name, bundle = model
    calls = _spy(monkeypatch, name)
    gen = torch.Generator().manual_seed(1)
    src = {"rgbs": scene["src_rgbs"], "cameras": scene["src_cameras"],
           "featmaps_clean": None}
    if path == "attack":
        cfg = AttackConfig(h=H, w=W, n_rand=16, adv_iters=1, use_adam=True)
        step = make_attack_step(bundle, _cfg(name), cfg)
        target = {"camera": scene["camera"], "rgb": scene["rgb"],
                  "depth": None, "depth_range": scene["depth_range"]}
        state, aux = step(init_attack_state(gen, cfg, src["rgbs"]), target,
                          src, generator=gen)
        out = [aux["loss"], state["delta"]]
    elif path == "train":
        step, _, _ = make_train_step(bundle, _cfg(name, det=False),
                                     TrainConfig(h=H, w=W, n_rand=16))
        batch = {"camera": scene["camera"], "rgb": scene["rgb"],
                 "depth_range": scene["depth_range"],
                 "src_rgbs": scene["src_rgbs"],
                 "src_cameras": scene["src_cameras"]}
        draws = step.draw(torch.Generator().manual_seed(2), batch)
        again = step.loss_and_grads(batch, draws)[0]["loss"]
        out = [step(batch, generator=torch.Generator().manual_seed(2))["loss"]]
        assert torch.equal(out[0], again)  # the step draws what draw gives
    else:
        with torch.no_grad():
            ret = render_single_image(
                bundle.nets, _batch(scene, slice(None)),
                bundle.extract_features(scene["src_rgbs"]), _cfg(name), H, W,
                scene["src_rgbs"], scene["src_cameras"], chunk_size=256,
                generator=gen)
        out = [ret["outputs_coarse"]["rgb"], ret["outputs_fine"]["rgb"]]
        assert out[0].shape == (H, W, 3)
        assert calls == [256, 256, 256]  # one render_draws a chunk
    assert calls and all(bool(torch.isfinite(x).all()) for x in out)


def _args(*flags):
    return port_parser().parse_args(["--backbone", "pixelnerf",
                                     "--pixelnerf_d_hidden", "32", *flags])


HYBRIDS = "renders in float32, without hybrids"


@pytest.mark.parametrize("flags, make, message", [
    (["--compute_dtype", "bfloat16"], "config", HYBRIDS),
    (["--use_clean_color"], "config", HYBRIDS),
    (["--use_clean_density"], "config", HYBRIDS),
    (["--feature_dtype", "bfloat16"], "model", "runs in float32"),
    ([], "bspg_render", "renders per tap, without hybrids"),
])
def test_pixelnerf_refuses_what_it_cannot_render(flags, make, message, scene):
    args = _args(*flags)
    with pytest.raises(ValueError, match=f"pixelNeRF {message}"):
        if make == "config":
            render_config_from_args(args, "frame", "cpu")
        elif make == "model":
            create_model(args=args)
        else:
            cfg = render_config_from_args(args, "frame", "cpu")
            bundle = create_model(args=args)
            rr.render_rays(bundle.nets, _batch(scene, slice(0, 8)),
                           bundle.extract_features(scene["src_rgbs"]),
                           dataclasses.replace(cfg,
                                               bspg_specs=("spec", "spec")),
                           scene["src_rgbs"], scene["src_cameras"])


def test_pixelnerf_frames_take_the_per_tap_gather(capsys):
    small = {"n_views": 6, "h": 48, "w": 64}
    args = _args("--eval_dataset", "synthetic", "--use_bspg", "True",
                 "--N_samples", "8", "--N_importance", "2",
                 "--num_source_views", "3")
    ev = Evaluator(args, dataset_kwargs=small, device="cpu", seed=0)
    for _ in range(2):
        assert ev.view_render_cfg(3).bspg_specs is None
    said = capsys.readouterr().out.splitlines()
    assert said.count("whole-frame renders take the per-tap gather: "
                      "pixelNeRF gathers its latent map per tap") == 1


GNT_FLAGS = {"--gnt_fused_attack": ["False", "True"],
             "--gnt_fused_attn": ["auto", "on", "off"],
             "--gnt_fused_vt": ["auto", "on", "off", "True", "False"],
             "--gnt_fused_chain": ["auto", "on", "off"]}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("use", ["frame", "attack", "train"])
def test_gnt_render_configs_follow_the_flags(use, device):
    """The fused routes of each use on each device (no card needed): frames
    take the chain (bf16) and the view attention on a CUDA device under
    ``auto``, the ray attention under ``--gnt_fused_attn on``; the attack
    step takes the ray attention under ``--gnt_fused_attack``, training
    under ``--gnt_fused_attn on``; neither takes the chain or the view
    attention."""
    cuda = device == "cuda"
    for values in itertools.product(*GNT_FLAGS.values()):
        flags = dict(zip(GNT_FLAGS, values))
        args = port_parser().parse_args(
            ["--backbone", "gnt", "--single_net", "True", "--ret_alpha"]
            + [x for kv in flags.items() for x in kv])
        attn, vt, chain = (flags["--gnt_fused_attn"], flags["--gnt_fused_vt"],
                           flags["--gnt_fused_chain"])
        vt = {"True": "on", "False": "off"}.get(vt, vt)
        want = {"frame": (attn == "on", chain == "on" or (
                              chain == "auto" and cuda),
                          vt == "on" or (vt == "auto" and cuda)),
                "attack": (flags["--gnt_fused_attack"] == "True", False,
                           False),
                "train": (attn == "on", False, False)}[use]
        cfg = render_config_from_args(args, use, torch.device(device))
        got = (cfg.gnt_fused_attn, cfg.gnt_fused_chain, cfg.gnt_fused_vt)
        assert got == want, (flags, got, want)
        assert cfg.single_net and cfg.ret_alpha and not cfg.stop_camera_grad
        assert cfg.bspg_specs is None


def test_an_unknown_backbone_is_refused():
    args = port_parser().parse_args([])
    args.backbone = "nerf"
    for make in (lambda: backbones.of("nerf"),
                 lambda: create_model(backbone="nerf"),
                 lambda: render_config_from_args(args)):
        with pytest.raises(ValueError, match="unknown backbone 'nerf'"):
            make()


@pytest.mark.parametrize("backbone", backbones.NAMES)
def test_a_frame_config_needs_its_device(backbone):
    """GNT's ``auto`` kernel routes read the device: a frame's config is
    refused without it, the other uses do not read it."""
    args = _args("--backbone", backbone)
    with pytest.raises(ValueError, match="needs its device"):
        render_config_from_args(args, "frame")
    for use in (None, "attack", "train"):
        render_config_from_args(args, use)
