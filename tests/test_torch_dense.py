"""K6, pixelNeRF's ``ResnetFC`` products (``nerfool_tpu_torch/ops/linear.py``).

On the CPU: the plain versions, forward and input gradient, against
``F.linear`` with its ReLU, bias and addend and against autograd in float64
for every option; the residual block's backward through the operators by
``torch.autograd.gradcheck``, and against the module's layers; the routing
(a CPU tensor takes the plain version, bf16 the module's layers, the
kernel's wrappers refuse CPU tensors, the weight gradients only where a
parameter requires them); the layout the kernel reads the latent taps in;
``ResnetFC``'s parameter names; the operators' names; and that IBRNet's and
GNT's aggregators hold no K6 layer. On the card (``-m cuda``, skipped
here): the kernel against float64 at the cell's shapes beside cuBLAS's f32
on the same inputs, the launches of one pixelNeRF attack step, and a shape
the kernel refuses.

Imports no JAX: the card runs this file with ``--noconftest``.
"""
from __future__ import annotations

import inspect
import itertools

import pytest
import torch
import torch.nn.functional as F

from nerfool_tpu_torch.models import gnt, ibrnet, pixelnerf
from nerfool_tpu_torch.models.bundle import create_model
from nerfool_tpu_torch.ops import linear

torch.set_num_threads(2)

FORWARD_OPTIONS = list(itertools.product([False, True], repeat=3))


def _fwd_id(o):
    relu, bias, addend = o
    return f"relu{int(relu)}-bias{int(bias)}-addend{int(addend)}"


def _operands(shape, n, k, relu, bias, addend, dtype=torch.float64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, k, generator=gen, dtype=dtype)
    w = torch.randn(n, k, generator=gen, dtype=dtype) / k ** 0.5
    b = torch.randn(n, generator=gen, dtype=dtype) if bias else None
    ad = torch.randn(*shape, n, generator=gen, dtype=dtype) if addend else None
    return x, w, b, ad


@pytest.mark.parametrize("opts", FORWARD_OPTIONS, ids=_fwd_id)
def test_plain_matches_linear_float64(opts):
    """The plain forward equals ``F.linear`` of the input (after its ReLU)
    plus the bias and the addend, and the plain input gradient equals
    autograd's through them, ReLU mask and the addend's gradient included,
    in float64 (1e-13 of the largest entry: the same sums, in another
    order at most)."""
    relu, bias, addend = opts
    x, w, b, ad = _operands((3, 5), 24, 16, relu, bias, addend)
    x.requires_grad_(True)
    y = linear.dense_plain(x, w, b, ad, relu)
    ref = F.linear(F.relu(x) if relu else x, w, b)
    ref = ref if ad is None else ref + ad
    assert (y - ref).abs().max() <= 1e-13 * ref.abs().max()
    cot = torch.randn(ref.shape, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(1))
    want, = torch.autograd.grad(ref, x, cot)
    other = torch.randn(x.shape, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(2))
    got = linear.dense_input_grad_plain(cot, w, x.detach() if relu else None,
                                        other if addend else None)
    if addend:
        want = want + other
    assert (got - want).abs().max() <= 1e-13 * want.abs().max()


def _block_params(size, latent, seed=3):
    gen = torch.Generator().manual_seed(seed)

    def lin(n, k):
        return (torch.randn(n, k, generator=gen, dtype=torch.float64)
                / k ** 0.5).requires_grad_(True), torch.randn(
            n, generator=gen, dtype=torch.float64).requires_grad_(True)

    wz, bz = lin(size, latent)
    w0, b0 = lin(size, size)
    w1, b1 = lin(size, size)
    return wz, bz, w0, b0, w1, b1


@pytest.mark.parametrize("with_taps", [True, False],
                         ids=["per_view", "pooled"])
def test_residual_block_gradcheck(with_taps):
    """The block through the operators (the plain versions on the CPU):
    every input's and parameter's gradient, the latent taps as the
    transposed view ``latent_taps`` hands over, against finite differences
    (``torch.autograd.gradcheck``, float64)."""
    gen = torch.Generator().manual_seed(4)
    v, p, size, latent = 2, 6, 8, 12
    h = torch.randn(v, p, size, generator=gen,
                    dtype=torch.float64).requires_grad_(True)
    taps = None
    if with_taps:
        taps = torch.randn(v, latent, p, generator=gen, dtype=torch.float64
                           ).transpose(1, 2).requires_grad_(True)
    wz, bz, w0, b0, w1, b1 = _block_params(size, latent)
    if not with_taps:
        wz = bz = None
    assert torch.autograd.gradcheck(
        lambda *a: linear.ResidualBlock.apply(*a),
        (h, taps, wz, bz, w0, b0, w1, b1))


@pytest.mark.parametrize("with_taps", [True, False],
                         ids=["per_view", "pooled"])
def test_resnet_block_matches_the_layers_float64(with_taps):
    """``ResnetBlockFC`` through ``resnet_block`` against the same module
    through its ``nn.Linear`` layers, forward and every gradient, in
    float64 (1e-13 of the largest entry)."""
    torch.manual_seed(5)
    blk = pixelnerf.ResnetBlockFC(16).double()
    lin_z = torch.nn.Linear(12, 16).double() if with_taps else None
    gen = torch.Generator().manual_seed(6)
    h = torch.randn(2, 3, 4, 16, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    taps = torch.randn(2, 12, 12, generator=gen, dtype=torch.float64
                       ).transpose(1, 2).reshape(2, 3, 4, 12)
    taps = taps.detach().requires_grad_(True) if with_taps else None
    params = list(blk.parameters()) + (list(lin_z.parameters())
                                       if with_taps else [])
    inputs = [h] + ([taps] if with_taps else [])
    cot = torch.randn(2, 3, 4, 16, generator=gen, dtype=torch.float64)

    def run():
        y = blk(h, lin_z, taps)
        return (y,) + torch.autograd.grad(y, inputs + params, cot)

    got = run()
    takes = linear.takes
    linear.takes = lambda t: False
    try:
        want = run()
    finally:
        linear.takes = takes
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-13 * b.abs().max()


def _ops_run(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


@pytest.mark.parametrize("frozen", [True, False])
def test_weight_grad_only_where_asked(frozen):
    """With frozen parameters (the attack) the backward runs the input
    gradients alone: no parameter gradient. Where the parameters require
    grad (the trainer) they equal the layers' in float64 (1e-13 of the
    largest entry)."""
    torch.manual_seed(7)
    blk = pixelnerf.ResnetBlockFC(16).double()
    lin_z = torch.nn.Linear(16, 16).double()
    for m in (blk, lin_z):
        m.requires_grad_(not frozen)
    gen = torch.Generator().manual_seed(8)
    h = torch.randn(2, 10, 16, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    taps = torch.randn(2, 10, 16, generator=gen, dtype=torch.float64)
    cot = torch.randn(2, 10, 16, generator=gen, dtype=torch.float64)
    names = _ops_run(lambda: blk(h, lin_z, taps).backward(cot))
    assert "nerfool_torch::dense_input_grad" in names
    params = list(blk.parameters()) + list(lin_z.parameters())
    if frozen:
        assert all(p.grad is None for p in params)
        return
    got = [p.grad.clone() for p in params]
    for p in params:
        p.grad = None
    takes = linear.takes
    linear.takes = lambda t: False
    try:
        blk(h, lin_z, taps).backward(cot)
    finally:
        linear.takes = takes
    for a, p in zip(got, params):
        assert (a - p.grad).abs().max() <= 1e-13 * p.grad.abs().max()


def test_cpu_takes_the_plain_version(monkeypatch):
    """float32 and float64 CPU tensors go through the operators' plain
    versions, never the kernel's wrappers, and count no launch; autograd
    reaches the input-gradient operator: 3 + 3 calls a per-view block, 2 + 2
    a pooled one."""
    calls = {"fwd": 0, "grad": 0}
    plain, plain_grad = linear.dense_plain, linear.dense_input_grad_plain

    def fwd(*a):
        calls["fwd"] += 1
        return plain(*a)

    def grad(*a):
        calls["grad"] += 1
        return plain_grad(*a)

    def kernel(*a):
        raise AssertionError("the kernel's wrapper was called")

    counters = linear.dense_forward, linear.dense_input_grad
    launches = tuple(f.launches for f in counters)
    monkeypatch.setattr(linear, "dense_plain", fwd)
    monkeypatch.setattr(linear, "dense_input_grad_plain", grad)
    monkeypatch.setattr(linear, "dense_forward", kernel)
    monkeypatch.setattr(linear, "dense_input_grad", kernel)
    for dtype in (torch.float32, torch.float64):
        assert linear.takes(torch.zeros(1, dtype=dtype))
        blk = pixelnerf.ResnetBlockFC(8).to(dtype)
        lin_z = torch.nn.Linear(8, 8).to(dtype)
        h = torch.randn(2, 5, 8, dtype=dtype, requires_grad=True)
        taps = torch.randn(2, 5, 8, dtype=dtype, requires_grad=True)
        torch.autograd.grad(blk(blk(h, lin_z, taps)).sum(), (h, taps))
    assert calls == {"fwd": 10, "grad": 10}
    assert tuple(f.launches for f in counters) == launches


def test_bf16_keeps_the_layers(monkeypatch):
    """bfloat16 (neither route of K6) runs the module's ``nn.Linear``
    layers: the operators are not called."""
    def refuse(*a):
        raise AssertionError("the K6 operators were called")

    torch.manual_seed(9)
    blk = pixelnerf.ResnetBlockFC(16)
    lin_z = torch.nn.Linear(16, 16)
    x = torch.randn(2, 6, 16)
    taps = torch.randn(2, 6, 16)
    ref = blk(x, lin_z, taps)
    monkeypatch.setattr(linear, "resnet_block", refuse)
    assert not linear.takes(x.bfloat16())
    y = blk.bfloat16()(x.bfloat16(), lin_z.bfloat16(), taps.bfloat16())
    assert y.dtype == torch.bfloat16
    assert (y.float() - ref).abs().max() <= 0.05 * ref.abs().max()


def test_the_kernels_wrappers_refuse_cpu_tensors():
    """The kernel's wrappers take CUDA tensors only; they raise on others
    (the routing never sends them any)."""
    x, w = torch.zeros(4, 128), torch.zeros(128, 128)
    with pytest.raises(ValueError, match="CUDA"):
        linear.dense_forward(x, w, None, None, True)
    with pytest.raises(ValueError, match="CUDA"):
        linear.dense_input_grad(x, w, x, None)


def test_the_taps_are_read_in_place():
    """``latent_taps``' transposed view reaches the kernel as the [V, P, K]
    view of grid_sample's [V, K, P] output (no copy); a contiguous input as
    it is; another layout as a contiguous copy."""
    base = torch.randn(3, 16, 40)
    taps = base.transpose(1, 2).reshape(3, 5, 8, 16)
    a, views = linear.a_layout(taps)
    assert views == 3 and a.shape == (3, 40, 16)
    assert a.data_ptr() == base.data_ptr() and a.stride() == (640, 1, 40)
    x = torch.randn(3, 40, 16)
    assert linear.a_layout(x) == (x, 0)
    odd = torch.randn(3, 16, 42).transpose(1, 2)  # rows not a multiple of 4
    a, views = linear.a_layout(odd)
    assert views == 0 and a.is_contiguous() and torch.equal(a, odd)


def test_resnetfc_parameter_names_are_pixelnerfs():
    """K6 changes no parameter: ``ResnetFC``'s state dict keeps
    pixelNeRF's names and shapes, and its checkpoint's split is unchanged."""
    net = pixelnerf.ResnetFC(32)
    assert set(net.state_dict()) == {f"{m}.{p}" for p in ("weight", "bias")
                                     for m in (["lin_in", "lin_out"] + [
                                         f"lin_z.{i}" for i in range(3)] + [
                                         f"blocks.{i}.fc_{k}"
                                         for i in range(5) for k in (0, 1)])}
    flat = {f"mlp_coarse.{k}": v for k, v in net.state_dict().items()}
    flat["encoder.model.layer4.0.conv1.weight"] = torch.zeros(1)
    split = pixelnerf.split_checkpoint(flat)
    assert set(split["net_coarse"]) == set(net.state_dict())
    assert split["net_fine"] is None and split["feature_net"] == {}


def test_operators_hold_no_convolution_name():
    """The launches run inside ``nerfool_torch::dense`` and
    ``::dense_input_grad``, names without "convolution", which the
    benchmark's traced reader of the feature net takes."""
    torch.manual_seed(10)
    net = pixelnerf.ResnetFC(16)
    latent = torch.randn(2, 3, 4, 512, requires_grad=True)
    x = torch.randn(2, 3, 4, pixelnerf.D_IN)
    names = _ops_run(lambda: net(latent, x).sum().backward())
    ours = {n for n in names if n.startswith("nerfool_torch::")}
    assert ours == {"nerfool_torch::dense", "nerfool_torch::dense_input_grad"}
    assert not any("convolution" in n for n in ours)


def test_ibrnet_and_gnt_hold_no_k6_layer():
    """Only pixelNeRF's ``ResnetFC`` runs K6: IBRNet's and GNT's modules
    hold no ``ResnetBlockFC`` and their sources do not reach the module."""
    for backbone, module in (("ibrnet", ibrnet), ("gnt", gnt)):
        bundle = create_model(backbone=backbone, seed=0, trans_depth=2)
        for net in (bundle.net_coarse, bundle.net_fine):
            if net is not None:
                assert not any(isinstance(m, pixelnerf.ResnetBlockFC)
                               for m in net.modules())
        assert all(v is not linear for v in vars(module).values())
        assert "resnet_block" not in inspect.getsource(module)


# ---- on the card ----

def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")


# (rows, views): the cell's fine level (10 sources x 512 rays x 96 samples,
# row-major: fc_0, fc_1 and every input gradient), its coarse level's taps
# (64 samples, the M-major view lin_z reads), and ragged row counts of both
CARD_SHAPES = [(491520, 0), (327680, 10), (491520 - 77, 0), (10 * 4100, 10)]


def _shape_id(s):
    rows, views = s
    return f"{rows}{'-taps' if views else ''}"


def _card_operands(rows, views, n, k, gen):
    if views:
        x = torch.randn(views, k, rows // views, device="cuda",
                        generator=gen).transpose(1, 2)
    else:
        x = torch.randn(rows, k, device="cuda", generator=gen)
    w = torch.randn(n, k, device="cuda", generator=gen) / k ** 0.5
    return x, w


def _err(a, ref):
    return float((a.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("opts", FORWARD_OPTIONS, ids=_fwd_id)
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=_shape_id)
def test_kernel_forward_against_float64(shape, opts):
    """The forward at the cell's shapes against float64, beside cuBLAS's
    f32 (TF32 off) on the same inputs: the kernel's largest error, as a
    share of the largest entry, is no more than twice cuBLAS's."""
    _require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    relu, bias, addend = opts
    gen = torch.Generator(device="cuda").manual_seed(shape[0] + 3 * relu)
    x, w = _card_operands(*shape, 512, 512, gen)
    b = torch.randn(512, device="cuda", generator=gen) if bias else None
    ad = torch.randn(*x.shape[:-1], 512, device="cuda",
                     generator=gen) if addend else None
    before = linear.dense_forward.launches
    y = linear.dense_forward(x, w, b, ad, relu)
    torch.cuda.synchronize()
    assert linear.dense_forward.launches == before + 1
    ref = linear.dense_plain(x.double(), w.double(), None if b is None
                             else b.double(), None if ad is None
                             else ad.double(), relu)
    k6 = _err(y, ref)
    lib = _err(linear.dense_plain(x, w, b, ad, relu), ref)
    print(f"forward {shape} {opts}: K6 {k6:.3e}, cuBLAS f32 {lib:.3e}")
    assert k6 <= 2 * lib


@pytest.mark.cuda
@pytest.mark.parametrize("addend", [False, True])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("shape", CARD_SHAPES[::2], ids=_shape_id)
def test_kernel_input_grad_against_float64(shape, mask, addend):
    """The input gradient at the cell's row counts (the gradients are
    row-major) against float64, beside cuBLAS's f32: no more than twice
    cuBLAS's largest error."""
    _require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(shape[0] + 5 * mask)
    dy, w = _card_operands(shape[0], 0, 512, 512, gen)
    x = torch.randn(dy.shape, device="cuda", generator=gen) if mask else None
    other = torch.randn(dy.shape, device="cuda",
                        generator=gen) if addend else None
    before = linear.dense_input_grad.launches
    g = linear.dense_input_grad(dy, w, x, other)
    torch.cuda.synchronize()
    assert linear.dense_input_grad.launches == before + 1
    ref = linear.dense_input_grad_plain(
        dy.double(), w.double(), None if x is None else x.double(),
        None if other is None else other.double())
    k6 = _err(g, ref)
    lib = _err(linear.dense_input_grad_plain(dy, w, x, other), ref)
    print(f"input gradient {shape} mask {mask} addend {addend}: K6 "
          f"{k6:.3e}, cuBLAS f32 {lib:.3e}")
    assert k6 <= 2 * lib


# K6's launches in one pixelNeRF attack step, from the model's layout: each
# of the two nets runs COMBINE_LAYER per-view blocks of three launches (lin_z
# with the block input as addend, fc_0, fc_1) and N_BLOCKS - COMBINE_LAYER
# pooled blocks of two, forward and input gradient alike
STEP_LAUNCHES = 2 * (pixelnerf.COMBINE_LAYER * 3
                     + (pixelnerf.N_BLOCKS - pixelnerf.COMBINE_LAYER) * 2)


@pytest.mark.cuda
def test_attack_step_launches():
    """One pixelNeRF attack step on the card (the benchmark cell's flags at
    a small rig, a hidden width of 128) runs 26 forward and 26
    input-gradient launches of K6."""
    _require_cuda()
    from nerfbench import program
    from nerfbench.scene import Rig
    from nerfbench.tests.tiny import tiny_cell
    from nerfool_tpu_torch.attack.attack import (init_attack_state,
                                                 make_attack_step)
    from nerfool_tpu_torch.engine import Evaluator, build_attack_config

    assert STEP_LAUNCHES == 26
    cell = tiny_cell("pixelnerf_mv_attack")
    cell.config["flags"]["pixelnerf_d_hidden"] = 128
    seed = 2 ** 31 + 28
    sd = program.weights(cell.config, cell.traffic, seed, "cuda")
    args = program.port_args(cell.config, cell.traffic)
    bundle = create_model(args=args, state_dicts=sd, device="cuda")
    rig = Rig(cell.scene, seed, "cuda")
    ev = Evaluator(args, bundle=bundle, dataset_kwargs=args.dataset_kwargs,
                   device="cuda", seed=seed)
    target, (h, w) = ev._make_target(rig.views[0])
    cfg = build_attack_config(args, h, w)
    step = make_attack_step(bundle, ev._grad_render_cfg(), cfg)
    src = ev._make_src(rig.views[0])
    state = init_attack_state(ev.generator, cfg, src["rgbs"])
    before = (linear.dense_forward.launches, linear.dense_input_grad.launches)
    step(state, target, src, generator=ev.generator)
    torch.cuda.synchronize()
    assert (linear.dense_forward.launches - before[0],
            linear.dense_input_grad.launches - before[1]) == (
        STEP_LAUNCHES, STEP_LAUNCHES)


@pytest.mark.cuda
def test_kernel_refuses_a_shape():
    """An output width that is not a multiple of 128 (or an inner size
    that is not a multiple of 32) raises ValueError, with no launch
    counted, in both directions."""
    _require_cuda()
    x = torch.randn(64, 96, device="cuda")
    before = (linear.dense_forward.launches, linear.dense_input_grad.launches)
    with pytest.raises(ValueError, match="refused the shape"):
        linear.dense_forward(x, torch.randn(100, 96, device="cuda"), None,
                             None, False)
    with pytest.raises(ValueError, match="refused the shape"):
        linear.dense_input_grad(torch.randn(64, 128, device="cuda"),
                                torch.randn(128, 100, device="cuda"), None,
                                None)
    assert (linear.dense_forward.launches,
            linear.dense_input_grad.launches) == before


def test_trainer_runs_the_blocks(tmp_path, monkeypatch):
    """pixelNeRF's training step (``python -m nerfool_tpu_torch.train``,
    which hands the renderer pixelNeRF's four draws) runs each block
    through the operators: 26 forward and 26 input-gradient calls a step
    (the encoder's parameters want the taps' gradient), to a finite
    loss."""
    from nerfool_tpu_torch.train.__main__ import main as train_main

    calls = {"fwd": 0, "grad": 0}
    plain, plain_grad = linear.dense_plain, linear.dense_input_grad_plain

    def fwd(*a):
        calls["fwd"] += 1
        return plain(*a)

    def grad(*a):
        calls["grad"] += 1
        return plain_grad(*a)

    monkeypatch.setattr(linear, "dense_plain", fwd)
    monkeypatch.setattr(linear, "dense_input_grad_plain", grad)
    trainer = train_main([
        "--train_dataset", "synthetic", "--device", "cpu", "--backbone",
        "pixelnerf", "--pixelnerf_d_hidden", "32", "--pixelnerf_n_depth", "4",
        "--ckpt_path", "", "--n_iters", "1", "--N_samples", "8",
        "--N_importance", "4", "--num_source_views", "4", "--N_rand", "32",
        "--workers", "0", "--no_reload", "--i_img", "0", "--i_weights",
        "1000", "--i_print", "1", "--out_dir", str(tmp_path),
        "--dataset_kwargs", '{"n_views": 8, "h": 24, "w": 32}'])
    assert calls == {"fwd": 26, "grad": 26}
    assert [h["step"] for h in trainer.history] == [1]
    assert torch.isfinite(torch.tensor(trainer.history[0]["loss"]))
