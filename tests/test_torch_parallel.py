"""The port's ``parallel/`` (``nerfool_tpu_torch/parallel``): the per-rank
index and seed arithmetic against the JAX package's, and two gloo processes
on the CPU against one process.

The two-process world mirrors tests/test_multihost.py: this file, run as a
script, is the worker (``python tests/test_torch_parallel.py RANK WORLD
INIT_URL OUT_DIR``). Each rank joins the group through a ``file://``
rendezvous in the test's own temporary directory (so that test workers
never collide), builds the evaluator, which finds the group and splits its
rays, and saves its results; the one-process results come from the same
functions in the test process.

What the two ranks must reproduce, per rank: one view-specific attack step
per backbone (GNT through the ray-attention kernel's plain version; GNT's
config default is ``single_net``, one feature head, and a case with two
heads beside it), the universal step (the global source set, pseudo ground
truth), the PCGrad step (rgb, depth variance and depth smoothness on a
dedicated batch of whole 4x4 patches), a step under IBRNet's ``geo_noise``
(its draws taken for the whole batch in the one-process order), the
camera-pose attack with both consistency terms (its camera gradient flows
through the z-buffered warps, which every rank computes in full and
differentiates on its own rays only), one attacked whole-frame render on
the BSPG route under ``geo_noise`` (each rank renders whole chunks of ray
blocks with those chunks' draws), and one train step (each rank its own
view and draws, the gradients averaged over the ranks before Adam). Every
attack step runs the feature net on the rank's own source views (3 views on
two ranks: 2 | 1; one case with a single view, which leaves rank 1 none)
and gathers the maps; a forward hook counts the views the feature net
takes, and ``--shard_rays False`` turns both splits off. The attack and
train steps run in float64: a split changes only the order in which the
rays' contributions to a gradient are summed (each rank's own, then the
all-reduce), ~1e-16 relative in float64, so losses, deltas, Adam's moments
and parameters are held to 1e-6 relative (1e-12 of scale absolute, for
entries near zero). The render runs in float32 on chunks equal to the
one-process chunks, so each ray's arithmetic is the one-process arithmetic
(1e-6 absolute).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # when run as the worker script
    sys.path.insert(0, REPO)

from nerfool_tpu_torch import eval_adv  # noqa: E402
from nerfool_tpu_torch.attack.attack import init_attack_state  # noqa: E402
from nerfool_tpu_torch.attack.attack import make_attack_step  # noqa: E402
from nerfool_tpu_torch.engine import Evaluator, build_attack_config  # noqa
from nerfool_tpu_torch.parallel import distributed as t_dist  # noqa: E402
from nerfool_tpu_torch.parallel.mesh import (RaySplit,  # noqa: E402
                                             pad_to_multiple, ray_split)

SMALL = {"n_views": 6, "h": 24, "w": 32}
FRAME = {"n_views": 6, "h": 48, "w": 64}  # the BSPG planner's smallest rig
WORLD = 2
RANK_TIMEOUT = 300  # seconds for each spawned rank

# name -> (backbone, flags)
ATTACK_CASES = {
    "ibrnet": ("ibrnet", []),
    "gnt": ("gnt", ["--gnt_fused_attack", "True"]),
    "pcgrad": ("ibrnet", ["--use_pcgrad", "--depth_var_loss", "0.1",
                          "--depth_smooth_loss", "0.1", "--patch_size", "4",
                          "--N_importance", "4"]),
    "geo_noise": ("ibrnet", ["--geo_noise", "0.5", "--N_importance", "4"]),
    "pose_consistency": ("ibrnet", [
        "--perturb_camera", "--depth_consistency_loss", "0.5",
        "--camera_consistency_loss", "0.5", "--cam_src2tar", "1",
        "--cam_tar2src", "1", "--cam_depth", "0.1"]),
    # no --view_specific: one delta on the global source set
    "universal": ("ibrnet", ["--use_pseudo_gt", "--use_center_view",
                             "--N_importance", "4"]),
    "gnt_two_nets": ("gnt", ["--gnt_fused_attack", "True", "--single_net",
                             "False"]),
    # one source view: rank 1 owns none
    "one_view": ("gnt", ["--gnt_fused_attack", "True",
                         "--num_source_views", "1"]),
}
UNIVERSAL = ("universal",)


def _args(backbone, *extra, kw=SMALL, view_specific=True):
    flags = ["--eval_dataset", "synthetic", "--device", "cpu",
             "--ckpt_path", "", "--N_samples", "10", "--num_source_views",
             "3", "--N_rand", "32", "--use_adam", "--adam_lr", "1e-3",
             "--adv_iters", "1", "--workers", "0",
             "--dataset_kwargs", json.dumps(kw)]
    if view_specific:
        flags.append("--view_specific")
    if backbone == "gnt":
        flags += ["--backbone", "gnt", "--trans_depth", "2", "--ret_alpha"]
    return eval_adv.parse_args(flags + list(extra))


def _f64(d):
    return {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
            else v for k, v in d.items()}


def _attack(name, *more):
    """One attack step in float64 on test view 0 (the universal case: from
    the global source set), from a drawn delta; ``views``: the batch sizes
    the feature net took inside the step."""
    backbone, flags = ATTACK_CASES[name]
    universal = name in UNIVERSAL
    ev = Evaluator(_args(backbone, *flags, *more,
                         view_specific=not universal),
                   dataset_kwargs=SMALL, device="cpu", seed=0)
    net = ev.bundle.feature_net
    for m in (net, ev.bundle.net_coarse, ev.bundle.net_fine):
        if m is not None:
            m.double()
    data = ev.test_dataset[0]
    target, (h, w) = ev._make_target(data)
    cfg = build_attack_config(ev.args, h, w)
    target = _f64(target)
    src = _f64(ev.global_src() if universal else ev._make_src(data))
    if cfg.use_pseudo_gt:
        with torch.no_grad():
            src["featmaps_clean"] = ev.bundle.extract_features(src["rgbs"])
    step = make_attack_step(ev.bundle, ev._grad_render_cfg(), cfg,
                            split=ev.split)
    gen = torch.Generator().manual_seed(3)
    state = init_attack_state(gen, cfg, src["rgbs"])
    views = []
    hook = net.register_forward_pre_hook(
        lambda _, inputs: views.append(inputs[0].shape[0]))
    try:
        state, aux = step(state, target, src, generator=gen)
    finally:
        hook.remove()
    return {"split": ev.split is not None, "aux": aux, "views": views,
            "n_views": src["rgbs"].shape[0], "single_net": net.single_net,
            **{k: state[k] for k in ("delta", "m", "rot", "trans", "m_rot")}}


def _render(out_dir):
    """One attacked whole-frame render on the BSPG route, then one clean
    view through ``evaluate`` into ``out_dir``."""
    ev = Evaluator(_args("ibrnet", "--N_importance", "4", "--use_bspg",
                         "True", "--chunk_size", "256", "--geo_noise", "0.5",
                         kw=FRAME),
                   dataset_kwargs=FRAME, device="cpu", seed=0)
    data = ev.test_dataset[0]
    src = ev._make_src(data)
    assert ev.view_render_cfg(src["rgbs"].shape[0]).bspg_specs is not None
    u = torch.rand(src["rgbs"].shape,
                   generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        ret = ev.render_view(data, src, (2 * u - 1) * 8 / 255)
    ev.args.no_attack = True
    rows = ev.evaluate(max_views=1, verbose=False, out_dir=out_dir)
    return {"frame": {lvl: (None if o is None else
                            {k: v.clone() for k, v in o.items()})
                      for lvl, o in ret.items()},
            "rows": rows}


def _train_parts(rank, split):
    """(step, batch, generator) of an IBRNet train step in float64 on rank
    ``rank``'s own view and draws."""
    from nerfool_tpu_torch.data import dataset_dict
    from nerfool_tpu_torch.models.bundle import create_model
    from nerfool_tpu_torch.render.render_rays import RenderConfig
    from nerfool_tpu_torch.train.trainer import (TrainConfig, make_batch,
                                                 make_train_step)

    bundle = create_model(backbone="ibrnet", seed=0)
    for m in (bundle.feature_net, bundle.net_coarse, bundle.net_fine):
        m.double()
    ds = dataset_dict["synthetic"](_args("ibrnet"), "train", **SMALL)
    step, optimizer, _ = make_train_step(
        bundle, RenderConfig(n_samples=8, n_importance=4, det=False),
        TrainConfig(h=SMALL["h"], w=SMALL["w"], n_rand=32,
                    depth_var_loss=0.1), split=split)
    batch = make_batch(ds[rank], "cpu", torch.float64)
    gen = torch.Generator().manual_seed(t_dist.host_seed(0, rank))
    return step, optimizer, batch, gen


def _adam_moments(step, optimizer):
    """Adam's first moments after one step: 0.1 of the gradient it took,
    so the gradient's scale shows (the first update is near its sign)."""
    return [optimizer.state[p]["exp_avg"].clone() for p in step.params]


def _train(rank, split):
    step, optimizer, batch, gen = _train_parts(rank, split)
    aux = step(batch, generator=gen)
    return {"loss": aux["loss"],
            "params": [p.detach().clone() for p in step.params],
            "exp_avg": _adam_moments(step, optimizer)}


def _train_reference(world):
    """One process: every rank's gradients, averaged, then one Adam step."""
    step, optimizer, _, _ = _train_parts(0, None)
    grads, losses = None, []
    for r in range(world):
        _, _, batch, gen = _train_parts(r, None)
        aux, g = step.loss_and_grads(batch, step.draw(gen, batch))
        losses.append(aux["loss"])
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
    for p, g in zip(step.params, grads):
        p.grad = g / world
    optimizer.step()
    return {"losses": losses,
            "params": [p.detach().clone() for p in step.params],
            "exp_avg": _adam_moments(step, optimizer)}


def _worker(rank, world, init, out_dir):
    t_dist.initialize(backend="gloo", init_method=init, world_size=world,
                      rank=rank)
    split = ray_split()
    assert split == RaySplit(rank=rank, world=world)
    res = {"attack": {n: _attack(n) for n in ATTACK_CASES},
           "unsplit": _attack("ibrnet", "--shard_rays", "False"),
           "render": _render(os.path.join(out_dir, f"eval_rank{rank}")),
           "train": _train(rank, split),
           "main": t_dist.is_main_process(),
           "seed": t_dist.host_seed(777)}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


# ---- the index and seed arithmetic against the JAX package ----

def test_host_shard_and_seed_match_jax():
    from nerfool_tpu.parallel import distributed as j_dist

    for n in (0, 1, 5, 7, 8, 32, 800, 3072, 4097):
        for world in (1, 2, 3, 4, 8):
            got = [t_dist.host_shard(n, r, world) for r in range(world)]
            assert got == [j_dist.host_shard(n, r, world)
                           for r in range(world)], (n, world)
            covered = np.concatenate([np.arange(n)[s] for s in got])
            np.testing.assert_array_equal(covered, np.arange(n))
    for base in (0, 777, 880):
        for rank in range(4):
            assert t_dist.host_seed(base, rank) == j_dist.host_seed(base, rank)


def test_ray_split_rows_are_whole_units():
    for n, unit in ((32, 16), (48, 16), (3072, 256), (800, 1), (5, 4)):
        for world in (2, 3):
            rows = [RaySplit(r, world).rows(n, unit) for r in range(world)]
            assert rows[0].start == 0 and rows[-1].stop == n
            for a, b in zip(rows, rows[1:]):
                assert a.stop == b.start
            for s in rows:  # whole units but at the axis' end
                assert s.start % unit == 0 or s.start == n
                assert s.stop % unit == 0 or s.stop == n


def test_pad_to_multiple_matches_jax():
    from nerfool_tpu.parallel.mesh import pad_to_multiple as j_pad

    x = np.random.RandomState(0).rand(5, 3, 2).astype(np.float32)
    for multiple, axis in ((4, 0), (5, 0), (2, 1), (3, 2)):
        got, n = pad_to_multiple(torch.as_tensor(x), multiple, axis)
        ref, rn = j_pad(x, multiple, axis)
        assert n == rn
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_one_process_initialize_is_a_no_op():
    class Args:
        distributed = False
        device = "cpu"

    assert t_dist.initialize(Args()) == (0, 1)
    assert t_dist.initialize() == (0, 1)
    assert not torch.distributed.is_initialized()
    assert ray_split() is None and t_dist.is_main_process()
    x = torch.arange(6.0)
    assert t_dist.make_global(x, 6, slice(0, 6)) is x
    assert t_dist.host_seed(777) == 777


# ---- two gloo processes against one ----

def _spawn_world(world, tmp):
    env = {k: v for k, v in os.environ.items() if k not in (
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    init = f"file://{tmp}/rendezvous"
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world),
             init, str(tmp)], stdout=log, stderr=subprocess.STDOUT, env=env,
            cwd=str(tmp)))
    return procs, logs


def _collect_world(procs, logs, tmp):
    world = len(procs)
    fails = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        try:
            rc = p.wait(timeout=RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = "timeout"
        log.seek(0)
        tail = log.read()[-3000:]
        log.close()
        if rc != 0:
            fails.append(f"rank {r}/{world} rc={rc}:\n{tail}")
    assert not fails, "\n".join(fails)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two ranks' results and the one-process results."""
    tmp = tmp_path_factory.mktemp("world")
    procs, logs = _spawn_world(WORLD, tmp)
    try:  # the one-process results while the ranks run
        one = {"attack": {n: _attack(n) for n in ATTACK_CASES},
               "render": _render(str(tmp / "eval_one")),
               "train": _train_reference(WORLD)}
    finally:
        ranks = _collect_world(procs, logs, tmp)
    return ranks, one, tmp


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-6, err_msg=what,
                               atol=1e-12 * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("case", list(ATTACK_CASES))
def test_two_ranks_attack_step_matches_one_process(world, case):
    ranks, one, _ = world
    ref = one["attack"][case]
    assert not ref["split"]
    for r, res in enumerate(ranks):
        got = res["attack"][case]
        assert got["split"], r
        assert set(got["aux"]) == set(ref["aux"])
        for k in ref["aux"]:
            _close(got["aux"][k], ref["aux"][k], f"rank {r} {k}")
        names = ["delta", "m"]
        if case == "pose_consistency":
            names += ["rot", "trans", "m_rot"]
            assert float(ref["m_rot"].abs().max()) > 0
        for k in names:
            _close(got[k], ref[k], f"rank {r} {k}")
    # every rank holds the same update, bit for bit
    for k in ("delta", "rot", "trans"):
        assert torch.equal(ranks[0]["attack"][case][k],
                           ranks[1]["attack"][case][k]), k


def test_feature_net_takes_the_ranks_views(world):
    """Each rank's feature net takes its ``host_shard`` of the source views
    (2 | 1 of 3; 1 | 0 of one view), one process all of them, and so does
    every rank under ``--shard_rays False``."""
    ranks, one, _ = world
    for case in ATTACK_CASES:
        n = one["attack"][case]["n_views"]
        assert one["attack"][case]["views"] == [n], case
        for r, res in enumerate(ranks):
            share = t_dist.host_shard(n, r, WORLD)
            assert res["attack"][case]["views"] == [share.stop - share.start]
    assert [r["attack"]["ibrnet"]["views"] for r in ranks] == [[2], [1]]
    assert [r["attack"]["one_view"]["views"] for r in ranks] == [[1], [0]]
    # one feature head (one map gathered) and two
    assert one["attack"]["gnt"]["single_net"]
    assert not one["attack"]["gnt_two_nets"]["single_net"]
    ref = one["attack"]["ibrnet"]
    for r, res in enumerate(ranks):
        got = res["unsplit"]
        assert not got["split"] and got["views"] == [3]
        for k in ("delta", "m"):
            _close(got[k], ref[k], f"rank {r} unsplit {k}")
        _close(got["aux"]["loss"], ref["aux"]["loss"], f"rank {r} loss")


def test_two_ranks_render_match_one_process(world):
    ranks, one, tmp = world
    ref = one["render"]
    for r, res in enumerate(ranks):
        for lvl, outs in ref["frame"].items():
            assert (outs is None) == (res["render"]["frame"][lvl] is None)
            if outs is None:
                continue
            for k, v in outs.items():
                got = res["render"]["frame"][lvl][k]
                assert got.shape == v.shape, (r, lvl, k)
                np.testing.assert_allclose(got.float().numpy(),
                                           v.float().numpy(), atol=1e-6,
                                           err_msg=f"rank {r} {lvl} {k}")
        rows = res["render"]["rows"]["synthetic"]
        for view, row in ref["rows"]["synthetic"].items():
            if isinstance(row, dict):
                for k in ("coarse_psnr", "fine_psnr", "coarse_ssim",
                          "fine_ssim"):
                    assert rows[view][k] == pytest.approx(row[k], abs=1e-4)
    # rank 0 alone writes the results
    assert os.path.exists(tmp / "eval_rank0" / "psnr_synthetic.txt")
    assert not os.path.exists(tmp / "eval_rank1")
    assert ranks[0]["main"] and not ranks[1]["main"]
    assert ranks[0]["seed"] == 777 and ranks[1]["seed"] != 777


def test_two_ranks_train_step_matches_averaged_gradients(world):
    ranks, one, _ = world
    ref = one["train"]
    for r, res in enumerate(ranks):
        _close(res["train"]["loss"], ref["losses"][r], f"rank {r} loss")
        moved = 0
        for i, (p, q) in enumerate(zip(res["train"]["params"],
                                       ref["params"])):
            _close(p, q, f"rank {r} parameter {i}")
        # the averaged gradient's scale (a sum over the ranks fails here)
        assert sum(float(m.abs().max()) for m in ref["exp_avg"]) > 0
        for i, (m, q) in enumerate(zip(res["train"]["exp_avg"],
                                       ref["exp_avg"])):
            _close(m, q, f"rank {r} exp_avg {i}")
        for p, q in zip(ranks[0]["train"]["params"],
                        ranks[1]["train"]["params"]):
            assert torch.equal(p, q)
            moved += 1
        assert moved == len(ref["params"])
    # the ranks trained on different views
    assert ranks[0]["train"]["loss"] != ranks[1]["train"]["loss"]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
