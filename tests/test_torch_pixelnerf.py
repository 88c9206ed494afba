"""pixelNeRF on the port's normal path (``--backbone pixelnerf``) against
the benchmark's plain reference (``nerfbench/reference/pixelnerf.py``), on
the CPU at a tiny size with seeded random weights: the encoder's latent
map, the ``ResnetFC`` with its mean over the views, both levels of
``render_rays`` with handed draws, three attack steps through the
evaluator's step, and one ``Evaluator.render_view`` frame. Also the
parameter names (pixelNeRF's layout), the parser's defaults
(``conf/default_mv.conf``), the flat checkpoint's split, and two faults
that the comparisons must catch: a BatchNorm left in train mode and a
detached depth-guided sample.

The tolerances sit above f32 rounding between two implementations of one
function: the reference pads inside ``nn.Conv2d`` where the port pads with
``F.pad`` and convolves without padding, and projects a point with the
camera's rotation and focal lengths where the port multiplies by
``K inv(c2w)``. Sound readings sit 10-100x below them.
"""
import os

import numpy as np
import pytest
import torch

from nerfbench import program, run
from nerfbench.backbones import pixelnerf as backbone
from nerfbench.reference import pixelnerf as ref
from nerfbench.reference.render import rays_at
from nerfbench.scene import Rig
from nerfbench.tests.tiny import tiny_cell
from nerfool_tpu_torch.backbones import pixelnerf as pixelnerf_backbone
from nerfool_tpu_torch.config import port_parser
from nerfool_tpu_torch.engine import Evaluator, render_config_from_args
from nerfool_tpu_torch.models import pixelnerf
from nerfool_tpu_torch.models.bundle import create_model
from nerfool_tpu_torch.render import render_rays as rr

torch.set_num_threads(2)

SEED = 2 ** 31 + 28  # a seed whose random MLP gives density on the rays
CELL = "pixelnerf_mv_attack"
BENCH = run.benchmark()
# the comparison numbers of three attack steps (compare.attack_numbers):
# sound tiny runs read loss 1e-7, grad_norm 6e-7, change_norm 2.4e-6 and
# coarse_net 3e-8 (median) / 5e-8 (mean)
ATTACK = {"loss": 1e-5, "grad_norm": 1e-4, "change_norm": 1e-3,
          "coarse_net_median": 1e-6, "coarse_net_mean": 1e-6}


def _stats(sd, gen):
    """Running statistics and affine parameters of every BatchNorm drawn
    away from their defaults, so that eval mode is what is compared."""
    out = dict(sd)
    for k, x in sd.items():
        if k.endswith("running_mean") or k.endswith("bias") and "bn" in k:
            out[k] = 0.2 * torch.randn(x.shape, generator=gen)
        elif k.endswith("running_var") or k.endswith("weight") and (
                "bn" in k or "downsample.1" in k):
            out[k] = 0.5 + torch.rand(x.shape, generator=gen)
        elif "downsample.1.bias" in k:
            out[k] = 0.2 * torch.randn(x.shape, generator=gen)
    return out


def build(seed=SEED):
    """(cell, state dicts, port bundle, port args, reference feature net,
    reference model)"""
    cell = tiny_cell(CELL)
    gen = torch.Generator().manual_seed(seed)
    sd = program.weights(cell.config, cell.traffic, seed, "cpu")
    sd["feature_net"] = _stats(sd["feature_net"], gen)
    args = program.port_args(cell.config, cell.traffic)
    bundle = create_model(args=args, state_dicts=sd, device="cpu")
    feature_net, model = program.reference_model(cell.config, cell.traffic,
                                                 sd)
    return cell, sd, bundle, args, feature_net, model


def view_of(cell, seed=SEED):
    rig = Rig(cell.scene, seed, "cpu")
    v = rig.views[0]
    t = torch.as_tensor
    return rig, {"src_rgbs": t(v["src_rgbs"]), "src_cameras": t(v["src_cameras"]),
                 "camera": t(v["camera"]), "depth_range": t(v["depth_range"])}


def test_encoder_latent_matches_reference():
    cell, _, bundle, _, feature_net, _ = build()
    _, view = view_of(cell)
    with torch.no_grad():
        got, again = bundle.extract_features(view["src_rgbs"])
        want, _ = feature_net(view["src_rgbs"])
    assert got is again  # one map for both levels
    assert got.shape == (4, 512, 24, 32)  # 64 + 64 + 128 + 256 at H/2
    scale = float(want.abs().max())
    # f32 convolutions padded two ways: ~1e-7 of the map's scale
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


def test_resnetfc_matches_reference_with_the_view_mean():
    _, _, bundle, _, _, model = build()
    gen = torch.Generator().manual_seed(SEED + 1)
    latent = torch.randn(4, 16, 6, 512, generator=gen)
    x = torch.randn(4, 16, 6, 42, generator=gen)
    with torch.no_grad():
        got = bundle.net_coarse(latent, x)
        want = model["net_coarse"](latent, x)
        # the views are averaged after block 3: a view's change moves the
        # output, and the mean makes it independent of the views' order
        again = bundle.net_coarse(latent.flip(0), x.flip(0))
    assert got.shape == (16, 6, 4)
    # the same products in the same order: identical up to summation order
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(again, got, rtol=0, atol=1e-5)


def _draws(cell, n, seed):
    gen = torch.Generator().manual_seed(seed)
    return tuple((torch.rand if how == "uniform" else torch.randn)(
        shape, generator=gen)
        for shape, how in backbone.draw_shapes(cell.flags, n))


def test_render_rays_both_levels_match_reference():
    cell, _, bundle, args, feature_net, model = build()
    _, view = view_of(cell)
    sel = torch.randperm(48 * 64, generator=torch.Generator().manual_seed(
        SEED))[:64]
    rays_o, rays_d = rays_at(sel, view["camera"])
    draws = _draws(cell, 64, SEED + 2)
    cfg = render_config_from_args(args)
    with torch.no_grad():
        feats = bundle.extract_features(view["src_rgbs"])
        got = rr.render_rays(bundle.nets, {
            "ray_o": rays_o, "ray_d": rays_d,
            "depth_range": view["depth_range"].reshape(1, 2),
            "camera": view["camera"][None]}, feats, cfg, view["src_rgbs"],
            view["src_cameras"], samples=draws)
        want = backbone.render_rays(
            model, rays_o, rays_d, view["camera"], view["depth_range"],
            feature_net(view["src_rgbs"]), view["src_rgbs"],
            view["src_cameras"], given={"draws": draws})
    for level in ("coarse", "fine"):
        g, w = got[f"outputs_{level}"], want[level]
        assert g["weights"].shape == (64, 8 if level == "coarse" else 16)
        # rgb in [0, 1] and depths 1.2 to 21.3 through two projections
        torch.testing.assert_close(g["rgb"], w["rgb"], rtol=0, atol=1e-5)
        # depths (scene units, 1.2 to 21.3) move with sigma's rounding
        torch.testing.assert_close(g["depth"], w["depth"], rtol=1e-4,
                                   atol=1e-4)
        # the fine level's depth-guided samples sit at the coarse depth,
        # which carries its rounding (1e-5 of it), and their small gaps to
        # their neighbours amplify it in alpha
        torch.testing.assert_close(g["weights"], w["weights"], rtol=0,
                                   atol=1e-5 if level == "coarse" else 1e-4)


def attack_numbers(seed=SEED):
    result, numbers = run.run(tiny_cell(CELL, ATTACK), seed, 0.2, 0, "cpu",
                              BENCH)
    return result, numbers


def test_three_attack_steps_match_reference():
    result, numbers = attack_numbers()
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1
    for k, lim in ATTACK.items():
        assert numbers[k] <= lim, (k, numbers[k])


def _train_mode_batchnorm(monkeypatch):
    real = create_model

    def make(*a, **kw):
        bundle = real(*a, **kw)
        bundle.feature_net.train()
        return bundle

    monkeypatch.setattr("nerfool_tpu_torch.models.bundle.create_model", make)


def _detached_depth_samples(monkeypatch):
    real = pixelnerf_backbone.depth_samples
    monkeypatch.setattr(pixelnerf_backbone, "depth_samples",
                        lambda depth, *a: real(depth.detach(), *a))


@pytest.mark.parametrize("fault", ["train_mode_batchnorm",
                                   "detached_depth_samples"])
def test_a_fault_fails_the_comparison(fault, monkeypatch):
    if fault == "train_mode_batchnorm":
        _train_mode_batchnorm(monkeypatch)
    else:
        _detached_depth_samples(monkeypatch)
    result, numbers = attack_numbers()
    assert not result["correct"], numbers


def test_render_view_frame_matches_reference(tmp_path):
    cell, sd, _, args, feature_net, model = build()
    rig, view = view_of(cell)
    args.render_stride, args.chunk_size = 4, 256
    bundle = create_model(args=args, state_dicts=sd, device="cpu")
    ev = Evaluator(args, bundle=bundle, dataset_kwargs=args.dataset_kwargs,
                   device="cpu", seed=SEED)
    gen = torch.Generator().set_state(ev.generator.get_state())
    src = ev._make_src(rig.views[0])
    with torch.inference_mode():
        ret = ev.render_view(rig.views[0], src)
    hs, ws = 12, 16  # 48 x 64 at stride 4: one chunk of 192 rays
    cfg = render_config_from_args(args)
    draws = rr.render_draws(gen, cfg, hs * ws, torch.float32,
                            "cpu")["samples"]
    yy, xx = torch.meshgrid(torch.arange(0, 48, 4), torch.arange(0, 64, 4),
                            indexing="ij")
    rays_o, rays_d = rays_at((yy * 64 + xx).reshape(-1), view["camera"])
    with torch.no_grad():
        want = backbone.render_rays(
            model, rays_o, rays_d, view["camera"], view["depth_range"],
            feature_net(view["src_rgbs"]), view["src_rgbs"],
            view["src_cameras"], given={"draws": draws})
    for level in ("coarse", "fine"):
        got = ret[f"outputs_{level}"]["rgb"]
        assert got.shape == (hs, ws, 3)
        # the frame's rays are the pixels' (get_rays against rays_at)
        torch.testing.assert_close(got.reshape(-1, 3), want[level]["rgb"],
                                   rtol=0, atol=1e-5)


def test_parameter_names_follow_pixelnerfs_layout():
    bundle = create_model(backbone="pixelnerf", seed=0)
    enc = set(bundle.feature_net.state_dict())
    blocks = {"conv1.weight", "conv2.weight"} | {
        f"{bn}.{p}" for bn in ("bn1", "bn2") for p in (
            "weight", "bias", "running_mean", "running_var",
            "num_batches_tracked")}
    bn = {"weight", "bias", "running_mean", "running_var",
          "num_batches_tracked"}
    want = {"model.conv1.weight"} | {f"model.bn1.{p}" for p in bn}
    for stage, n in ((1, 3), (2, 4), (3, 6)):
        for j in range(n):
            want |= {f"model.layer{stage}.{j}.{k}" for k in blocks}
        if stage > 1:
            want |= {f"model.layer{stage}.0.downsample.0.weight"} | {
                f"model.layer{stage}.0.downsample.1.{p}" for p in bn}
    assert enc == want
    mlp = set(bundle.net_coarse.state_dict())
    assert mlp == {f"{m}.{p}" for p in ("weight", "bias") for m in (
        ["lin_in", "lin_out"] + [f"lin_z.{i}" for i in range(3)]
        + [f"blocks.{i}.fc_{k}" for i in range(5) for k in (0, 1)])}
    assert bundle.net_coarse.blocks[0].fc_0.weight.shape == (512, 512)
    assert bundle.net_coarse.lin_in.weight.shape == (512, 42)
    assert bundle.net_coarse.lin_z[0].weight.shape == (512, 512)
    assert bundle.net_fine is not bundle.net_coarse


def test_parser_defaults_equal_default_mv_conf():
    """default.conf's model.mlp_coarse / mlp_fine (n_blocks 5, d_hidden 512,
    combine_layer 3), model.code (num_freqs 6, freq_factor 1.5) and
    renderer (n_coarse 64, n_fine 32 of which n_fine_depth 16, depth_std
    0.01): the flags' defaults and the module's constants, and the same
    constants in the reference."""
    args = port_parser().parse_args(["--backbone", "pixelnerf"])
    assert (args.pixelnerf_d_hidden, args.pixelnerf_n_depth) == (512, 16)
    assert args.N_samples == 64
    assert render_config_from_args(args).n_depth == 16
    consts = (pixelnerf.N_BLOCKS, pixelnerf.COMBINE_LAYER, pixelnerf.PE_FREQS,
              pixelnerf.PE_FREQ_FACTOR, pixelnerf.DEPTH_STD, pixelnerf.D_IN,
              pixelnerf.LATENT)
    assert consts == (5, 3, 6, 1.5, 0.01, 42, 512)
    assert consts == (ref.N_BLOCKS, ref.COMBINE_LAYER, ref.N_FREQS,
                      ref.FREQ_FACTOR, ref.DEPTH_STD, ref.D_IN, ref.D_LATENT)


def test_positional_encoding_is_pixelnerfs():
    x = torch.tensor([[0.3, -1.2, 2.0]])
    got = pixelnerf.positional_encoding(x)
    want = [x]
    for k in range(6):
        f = 1.5 * 2.0 ** k
        want += [torch.sin(f * x), torch.cos(f * x)]
    assert got.shape == (1, 39)
    torch.testing.assert_close(got, torch.cat(want, dim=-1), rtol=0,
                               atol=1e-5)


def test_flat_checkpoint_loads_split_by_module(tmp_path):
    want = create_model(backbone="pixelnerf", seed=3, pixelnerf_d_hidden=32)
    flat = {"code._freqs": torch.ones(6, 1), "code._phases": torch.zeros(6, 1),
            "encoder.model.layer4.0.conv1.weight": torch.zeros(512, 256, 3, 3)}
    for name, prefix in (("feature_net", "encoder."),
                         ("net_coarse", "mlp_coarse."),
                         ("net_fine", "mlp_fine.")):
        for k, v in getattr(want, name).state_dict().items():
            flat[prefix + k] = v
    path = os.path.join(tmp_path, "pixel_nerf_latest")
    torch.save(flat, path)
    got = create_model(backbone="pixelnerf", ckpt_path=path,
                       pixelnerf_d_hidden=32)
    for name in ("feature_net", "net_coarse", "net_fine"):
        a = getattr(got, name).state_dict()
        b = getattr(want, name).state_dict()
        assert set(a) == set(b)
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert not got.feature_net.training


def test_eval_adv_runs_the_attack_and_frame(tmp_path, monkeypatch):
    """The view-specific attack and the attacked frame from the command
    line, as IBRNet and GNT run them."""
    from nerfool_tpu_torch import eval_adv

    monkeypatch.chdir(tmp_path)  # results under ./<dataset>/<expname>
    results = eval_adv.main([
        "--eval_dataset", "synthetic", "--device", "cpu", "--backbone",
        "pixelnerf", "--view_specific", "--adv_iters", "2", "--use_adam",
        "--adam_lr", "1e-3", "--adv_lr", "1", "--epsilon", "8", "--N_rand",
        "32", "--N_samples", "8", "--N_importance", "4",
        "--pixelnerf_n_depth", "4", "--pixelnerf_d_hidden", "32",
        "--num_source_views", "4", "--ckpt_path", "", "--max_views", "1",
        "--chunk_size", "512", "--render_stride", "2",
        "--dataset_kwargs", '{"n_views": 6, "h": 48, "w": 64}'])
    row = results["synthetic"]
    assert np.isfinite(row["coarse_mean_psnr"])
    assert np.isfinite(row["fine_mean_psnr"])
    assert os.path.exists(tmp_path / "synthetic" / "exp" / "synthetic"
                          / "psnr_synthetic.txt")


def test_spans_of_an_attack_step():
    """Under a CPU profiler one step records the latent once and each
    level's per-view and pooled MLP inside that level's aggregate span."""
    from torch.profiler import ProfilerActivity, profile

    from nerfool_tpu_torch.attack.attack import (init_attack_state,
                                                 make_attack_step)
    from nerfool_tpu_torch.engine import build_attack_config
    from nerfool_tpu_torch.utils.profiling import take_spans

    cell, sd, bundle, args, _, _ = build()
    rig, _ = view_of(cell)
    ev = Evaluator(args, bundle=bundle, dataset_kwargs=args.dataset_kwargs,
                   device="cpu", seed=SEED)
    target, (h, w) = ev._make_target(rig.views[0])
    cfg = build_attack_config(args, h, w)
    step = make_attack_step(bundle, ev._grad_render_cfg(), cfg)
    src = ev._make_src(rig.views[0])
    state = init_attack_state(ev.generator, cfg, src["rgbs"])
    take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, target, src, generator=ev.generator)
    recs = take_spans()
    by_id = {r.id: r for r in recs}
    names = [r.name for r in recs]
    assert names.count("pixelnerf.latent") == 1
    assert names.count("pixelnerf.views") == names.count(
        "pixelnerf.pooled") == 2
    parents = sorted(by_id[r.parent].name for r in recs
                     if r.name == "pixelnerf.views")
    assert parents == ["render.aggregate.coarse", "render.aggregate.fine"]
    latent = next(r for r in recs if r.name == "pixelnerf.latent")
    assert by_id[latent.parent].name == "attack.features"
