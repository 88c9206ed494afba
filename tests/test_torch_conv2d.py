"""K5, the feature net's convolutions (``nerfool_tpu_torch/ops/conv2d.py``).

On the CPU: the plain version, forward and input gradient, against
``nn.Conv2d`` and ``torch.autograd.grad`` in float64 for every convolution
the ResUNet has; the stride-2 input gradient's split by parity; and the
routing (a CPU tensor takes the plain version, bf16 the library's
``F.conv2d``, the weight gradient only where a parameter requires it). On
the card (``-m cuda``, skipped here): the kernel against the plain version
in float64 at the attack's shapes, and one ResUNet forward and backward
through 35 + 35 launches.

Imports no JAX: the card runs this file with ``--noconftest``.
"""
from __future__ import annotations

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfool_tpu_torch.models.layers import Conv2d
from nerfool_tpu_torch.models.resunet import ResUNet
from nerfool_tpu_torch.ops import conv2d

torch.set_num_threads(2)

# every distinct convolution of the ResUNet, as (c_in, c_out, k, stride,
# pad, bias): IBRNet's (two heads of 32, so 64 out) and GNT's single head
# (32 out) beside them; ``test_the_list_is_the_resunets`` holds it to the
# modules
CONVS = [
    (3, 64, 7, 2, 3, False),      # stem
    (64, 64, 3, 2, 1, False),     # layer1[0].conv1
    (64, 64, 3, 1, 1, False),     # layer1 conv2 and later blocks
    (64, 64, 1, 2, 0, False),     # layer1 downsample
    (64, 128, 3, 2, 1, False),    # layer2[0].conv1
    (128, 128, 3, 1, 1, False),
    (64, 128, 1, 2, 0, False),
    (128, 256, 3, 2, 1, False),   # layer3[0].conv1
    (256, 256, 3, 1, 1, False),
    (128, 256, 1, 2, 0, False),
    (256, 128, 3, 1, 1, True),    # upconv3, iconv3
    (128, 64, 3, 1, 1, True),     # upconv2, iconv2 (IBRNet)
    (64, 64, 1, 1, 0, True),      # out_conv (IBRNet)
    (128, 32, 3, 1, 1, True),     # iconv2 (GNT's single head)
    (32, 32, 1, 1, 0, True),      # out_conv (GNT)
]


def _ids(c):
    cin, cout, k, s, pad, bias = c
    return f"{cin}-{cout}-k{k}-s{s}-p{pad}{'-b' if bias else ''}"


def _resunet_convs(net):
    return {(m.in_channels, m.out_channels, m.kernel_size[0], m.stride[0],
             m.padding[0], m.bias is not None)
            for m in net.modules() if isinstance(m, Conv2d)}


def test_the_list_is_the_resunets():
    """CONVS is the set of the ResUNet's convolutions (both heads), and
    the benchmark's count of them is the module's: 35."""
    from nerfbench.counts.resunet import conv_layers

    ibr, gnt = ResUNet(32, 32), ResUNet(32, 32, single_net=True)
    assert _resunet_convs(ibr) | _resunet_convs(gnt) == set(CONVS)
    n = sum(isinstance(m, Conv2d) for m in ibr.modules())
    assert n == len(conv_layers(756, 1008, 64)) == 35


def _module(c, mode, dtype=torch.float64, seed=0):
    cin, cout, k, s, pad, bias = c
    gen = torch.Generator().manual_seed(seed)
    m = Conv2d(cin, cout, k, stride=s, padding=pad, bias=bias,
               padding_mode=mode)
    with torch.no_grad():
        m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                       / (cin * k * k) ** 0.5)
        if bias:
            m.bias.copy_(torch.randn(cout, generator=gen))
    return m.to(dtype)


def _library(m, x):
    """nn.Conv2d's own forward on the same parameters: the library's pad
    and convolution."""
    return nn.Conv2d.forward(m, x)


@pytest.mark.parametrize("mode", ["reflect", "zeros"])
@pytest.mark.parametrize("c", CONVS, ids=_ids)
def test_plain_matches_library_float64(c, mode):
    """Forward and input gradient of the port's convolution (pad, then the
    plain version: CPU tensors take it) against ``nn.Conv2d`` and autograd
    in float64, on an odd and an even frame: sums in another order, so
    ~1e-13 of the output's scale (1e-12 relative to the largest entry)."""
    m = _module(c, mode)
    gen = torch.Generator().manual_seed(1)
    for h, w in ((24, 32), (25, 31)):
        x = torch.randn(2, c[0], h, w, generator=gen, dtype=torch.float64,
                        requires_grad=True)
        y = m(x)
        ref = _library(m, x)
        assert y.shape == ref.shape
        assert (y - ref).abs().max() <= 1e-12 * ref.abs().max()
        cot = torch.randn(y.shape, generator=gen, dtype=torch.float64)
        gx, = torch.autograd.grad(y, x, cot)
        rx, = torch.autograd.grad(ref, x, cot)
        assert (gx - rx).abs().max() <= 1e-12 * rx.abs().max()


@pytest.mark.parametrize("hw", [(24, 32), (25, 33), (24, 33), (25, 32)])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_stride2_input_grad_split_by_parity(k, hw):
    """The stride-2 input gradient as four stride-1 problems, one per
    parity of the input pixel: each pixel belongs to one problem (the
    problems' grids tile the input exactly), a parity with no taps is
    zero, and the sum equals autograd's in float64 (1e-12 of the largest
    entry)."""
    h, w = hw
    probs = conv2d.input_grad_problems(k, k, 2, h, w)
    hit = torch.zeros(h, w, dtype=torch.int64)
    for a, b, th, tw, hi, wi in probs:
        assert len(range(a, h, 2)) == hi and len(range(b, w, 2)) == wi
        assert (th, tw) == (len(range(a, k, 2)), len(range(b, k, 2)))
        hit[a::2, b::2] += 1
    assert bool((hit == 1).all())
    gen = torch.Generator().manual_seed(k)
    x = torch.randn(2, 5, h, w, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    wt = torch.randn(7, 5, k, k, generator=gen, dtype=torch.float64)
    y = F.conv2d(x, wt, None, 2)
    cot = torch.randn(y.shape, generator=gen, dtype=torch.float64)
    ref, = torch.autograd.grad(y, x, cot)
    got = conv2d.conv2d_input_grad_plain(cot, wt, h, w, 2)
    assert (got - ref).abs().max() <= 1e-12 * ref.abs().max()
    if k == 1:
        assert bool((got[..., 1::2, :] == 0).all())
        assert bool((got[..., 1::2] == 0).all())


def test_stride1_input_grad_is_one_problem():
    """At stride 1 the input gradient is one problem over the whole input,
    with every tap."""
    assert conv2d.input_grad_problems(3, 3, 1, 10, 12) == [
        (0, 0, 3, 3, 10, 12)]


def test_cpu_takes_the_plain_version(monkeypatch):
    """A CPU tensor (float32 or float64) goes through the operators'
    plain versions, never the kernel's wrappers, and counts no launch;
    autograd reaches the input-gradient operator."""
    calls = {"fwd": 0, "grad": 0}
    plain, plain_grad = conv2d.conv2d_plain, conv2d.conv2d_input_grad_plain

    def fwd(*a):
        calls["fwd"] += 1
        return plain(*a)

    def grad(*a):
        calls["grad"] += 1
        return plain_grad(*a)

    def kernel(*a):
        raise AssertionError("the kernel's wrapper was called")

    launches = (conv2d.conv2d_forward.launches,
                conv2d.conv2d_input_grad.launches)
    counters = conv2d.conv2d_forward, conv2d.conv2d_input_grad
    monkeypatch.setattr(conv2d, "conv2d_plain", fwd)
    monkeypatch.setattr(conv2d, "conv2d_input_grad_plain", grad)
    monkeypatch.setattr(conv2d, "conv2d_forward", kernel)
    monkeypatch.setattr(conv2d, "conv2d_input_grad", kernel)
    for dtype in (torch.float32, torch.float64):
        assert conv2d.takes(torch.zeros(1, dtype=dtype))
        m = _module(CONVS[1], "reflect", dtype)
        x = torch.randn(1, 64, 24, 32, dtype=dtype, requires_grad=True)
        torch.autograd.grad(m(x).sum(), x)
    assert calls == {"fwd": 2, "grad": 2}
    assert tuple(f.launches for f in counters) == launches


def test_bf16_keeps_the_library_route(monkeypatch):
    """bfloat16 features (``--feature_dtype bfloat16``) keep the library's
    convolution: the operators are not called."""
    def refuse(*a):
        raise AssertionError("the K5 operators were called")

    monkeypatch.setattr(conv2d, "convolution", refuse)
    x = torch.randn(1, 64, 24, 32, dtype=torch.bfloat16)
    assert not conv2d.takes(x)
    m = _module(CONVS[2], "reflect", torch.float32)
    y = m(x)
    ref = _library(m, x.float())
    assert y.dtype == torch.bfloat16
    assert (y.float() - ref).abs().max() <= 0.05 * ref.abs().max()


def _ops_run(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


@pytest.mark.parametrize("frozen", [True, False])
def test_weight_grad_only_where_asked(frozen):
    """With frozen parameters (the attack) the backward runs the input
    gradient alone: no ``aten::convolution_backward``, no parameter
    gradient. Where the parameters require grad (the trainer) the library
    computes the weight and bias gradients, equal to ``nn.Conv2d``'s in
    float64 (1e-12 of the largest entry)."""
    m = _module(CONVS[10], "reflect")
    m.requires_grad_(not frozen)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 256, 12, 16, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    cot = torch.randn(2, 128, 12, 16, generator=gen, dtype=torch.float64)
    names = _ops_run(lambda: m(x).backward(cot))
    assert "nerfool_torch::convolution_input_grad" in names
    assert ("aten::convolution_backward" in names) is not frozen
    if frozen:
        assert m.weight.grad is None and m.bias.grad is None
        return
    ref = _module(CONVS[10], "reflect")
    nn.Conv2d.forward(ref, x.detach()).backward(cot)
    for got, want in ((m.weight.grad, ref.weight.grad),
                      (m.bias.grad, ref.bias.grad)):
        assert (got - want).abs().max() <= 1e-12 * want.abs().max()


def test_operators_carry_the_convolution_name():
    """The launches run inside operators whose names hold "convolution",
    which the benchmark's traced reader of the feature net takes."""
    m = _module(CONVS[1], "reflect", torch.float32)
    x = torch.randn(1, 64, 24, 32, requires_grad=True)
    names = _ops_run(lambda: m(x).sum().backward())
    assert {"nerfool_torch::convolution",
            "nerfool_torch::convolution_input_grad"} <= names


def test_the_kernels_wrappers_refuse_cpu_tensors():
    """The kernel's wrappers take CUDA tensors only; they raise on others
    (the routing never sends them any)."""
    x, w = torch.zeros(1, 3, 8, 8), torch.zeros(4, 3, 3, 3)
    with pytest.raises(ValueError, match="CUDA"):
        conv2d.conv2d_forward(x, w, None, 1)
    with pytest.raises(ValueError, match="CUDA"):
        conv2d.conv2d_input_grad(torch.zeros(1, 4, 6, 6), w, 8, 8, 1)


def test_resunet_features_and_vjp_float64():
    """The whole ResUNet through the port's convolutions against the same
    module through the library's, in float64: maps and input gradient to
    1e-10 of their scale."""
    torch.manual_seed(0)
    net = ResUNet(32, 32).double()
    x = torch.rand(2, 48, 64, 3, dtype=torch.float64, requires_grad=True)
    coarse, fine = net(x)
    cot = torch.randn(coarse.shape, dtype=torch.float64)
    g, = torch.autograd.grad((coarse * cot).sum() + fine.sum(), x)
    takes = conv2d.takes
    conv2d.takes = lambda t: False
    try:
        rc, rf = net(x)
        rg, = torch.autograd.grad((rc * cot).sum() + rf.sum(), x)
    finally:
        conv2d.takes = takes
    for a, b in ((coarse, rc), (fine, rf), (g, rg)):
        assert (a - b).abs().max() <= 1e-10 * b.abs().max()


# ---- on the card: the kernel against the plain version in float64 ----

ATTACK_VIEWS, ATTACK_HW = 10, (756, 1008)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")


def _attack_input_hw(c):
    """The input size of convolution ``c`` in the attack's ResUNet (10
    views at 756x1008), read from the module's forward."""
    sizes = {}
    net = ResUNet(32, 32, single_net=c[1] == 32 or c[0] == 32).to("meta")

    def hook(mod, inp, _):
        key = (mod.in_channels, mod.out_channels, mod.kernel_size[0],
               mod.stride[0], mod.padding[0], mod.bias is not None)
        sizes.setdefault(key, tuple(inp[0].shape[2:]))

    for m in net.modules():
        if isinstance(m, Conv2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        net(torch.zeros(1, *ATTACK_HW, 3, device="meta"))
    return sizes[c]


# The kernel computes each product as three TF32 products (a_hi b_hi + a_hi
# b_lo + a_lo b_hi: ~2^-21 of the product) and sums in f32, so its output
# lies ~1e-6 of the output's scale from float64, as a plain f32 sum does.
# TOL_REL bounds the largest deviation as a share of the largest entry of
# float64's result, 10x the largest measured (PERF.md, K5).
TOL_REL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("c", CONVS, ids=_ids)
def test_kernel_matches_plain_at_attack_shapes(c):
    """Forward and input gradient of the kernel at the attack's shape of
    convolution ``c`` against the plain version in float64 on the card
    (TOL_REL), with one launch each."""
    _require_cuda()
    cin, cout, k, s, pad, bias = c
    h, w = _attack_input_hw(c)
    hp, wp = h + 2 * pad, w + 2 * pad
    gen = torch.Generator(device="cuda").manual_seed(cin + cout + k)
    x = torch.randn(ATTACK_VIEWS, cin, hp, wp, device="cuda", generator=gen)
    wt = torch.randn(cout, cin, k, k, device="cuda", generator=gen) / (
        cin * k * k) ** 0.5
    b = torch.randn(cout, device="cuda", generator=gen) if bias else None
    before = (conv2d.conv2d_forward.launches,
              conv2d.conv2d_input_grad.launches)
    y = conv2d.conv2d_forward(x, wt, b, s)
    cot = torch.randn(y.shape, device="cuda", generator=gen)
    gx = conv2d.conv2d_input_grad(cot, wt, hp, wp, s)
    torch.cuda.synchronize()
    assert (conv2d.conv2d_forward.launches,
            conv2d.conv2d_input_grad.launches) == (before[0] + 1,
                                                   before[1] + 1)
    ref = conv2d.conv2d_plain(x.double(), wt.double(),
                              None if b is None else b.double(), s)
    assert (y.double() - ref).abs().max() <= TOL_REL * ref.abs().max()
    del ref
    gref = conv2d.conv2d_input_grad_plain(cot.double(), wt.double(), hp, wp,
                                          s)
    assert (gx.double() - gref).abs().max() <= TOL_REL * gref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [(5, 20, 3, 2, 1, True), (8, 24, 1, 2, 0, False),
                               (20, 36, 3, 1, 1, False),
                               (3, 5, 7, 2, 3, True)], ids=_ids)
def test_kernel_matches_plain_at_odd_shapes(c):
    """The kernel's other cases at small odd frames against the plain
    version in float64 (TOL_REL): channels that are not a multiple of 16
    (the gather table, at both strides), 8 output channels or fewer (the
    8-column tile), a 1x1 kernel at stride 2 (parities with no taps),
    widths that are not a multiple of a tile."""
    _require_cuda()
    cin, cout, k, s, pad, bias = c
    hp, wp = 37 + 2 * pad, 45 + 2 * pad
    gen = torch.Generator(device="cuda").manual_seed(cin * cout)
    x = torch.randn(2, cin, hp, wp, device="cuda", generator=gen)
    wt = torch.randn(cout, cin, k, k, device="cuda", generator=gen)
    b = torch.randn(cout, device="cuda", generator=gen) if bias else None
    y = conv2d.conv2d_forward(x, wt, b, s)
    cot = torch.randn(y.shape, device="cuda", generator=gen)
    gx = conv2d.conv2d_input_grad(cot, wt, hp, wp, s)
    ref = conv2d.conv2d_plain(x.double(), wt.double(),
                              None if b is None else b.double(), s)
    gref = conv2d.conv2d_input_grad_plain(cot.double(), wt.double(), hp, wp,
                                          s)
    assert (y.double() - ref).abs().max() <= TOL_REL * ref.abs().max()
    assert (gx.double() - gref).abs().max() <= TOL_REL * gref.abs().max()


@pytest.mark.cuda
def test_resunet_launches_on_the_card():
    """One forward and input gradient of the ResUNet in f32 on the card
    runs 35 forward and 35 input-gradient launches, and matches the
    float64 module to 1e-4 of the maps' scale (the InstanceNorms amplify
    the convolutions' rounding on the deepest maps)."""
    _require_cuda()
    torch.manual_seed(0)
    net = ResUNet(32, 32).cuda()
    x = torch.rand(2, 96, 128, 3, device="cuda", requires_grad=True)
    before = (conv2d.conv2d_forward.launches,
              conv2d.conv2d_input_grad.launches)
    coarse, fine = net(x)
    torch.autograd.grad(coarse.sum() + fine.sum(), x)
    torch.cuda.synchronize()
    assert (conv2d.conv2d_forward.launches - before[0],
            conv2d.conv2d_input_grad.launches - before[1]) == (35, 35)
    rc, _ = net.double()(x.double())
    assert (coarse.double() - rc).abs().max() <= 1e-4 * rc.abs().max()


@pytest.mark.cuda
def test_kernel_refuses_a_gather_past_its_table():
    """Channels that are not a multiple of 16 go through a gather table of
    1024 k values: 3 channels of a 19x19 kernel (1083) are refused with a
    ValueError and no launch counted, in both directions."""
    _require_cuda()
    x = torch.randn(1, 3, 40, 40, device="cuda")
    wt = torch.randn(4, 3, 19, 19, device="cuda")
    before = (conv2d.conv2d_forward.launches,
              conv2d.conv2d_input_grad.launches)
    with pytest.raises(ValueError, match="refused the shape"):
        conv2d.conv2d_forward(x, wt, None, 1)
    wg = torch.randn(3, 4, 19, 19, device="cuda")  # 3 gradient channels
    with pytest.raises(ValueError, match="refused the shape"):
        conv2d.conv2d_input_grad(torch.randn(1, 3, 22, 22, device="cuda"),
                                 wg, 40, 40, 1)
    assert (conv2d.conv2d_forward.launches,
            conv2d.conv2d_input_grad.launches) == before
