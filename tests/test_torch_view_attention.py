"""The plain version of the view-attention kernel (``ops/view_attention.py``)
and its routes through the port's GNT modules, against the JAX package on
the CPU.

The JAX side runs as tests/test_vt_kernel.py runs it: the flax
``ViewAttention`` module, and the Pallas kernel in interpret mode
(``fused=True``, and ``lane_pack=True`` for the lane-packed body). Inputs
come from numpy seeds; the weights are a flax GNT aggregator's, carried into
the port by ``convert.gnt_state_dict`` (what ``params_from_flax`` applies to
a GNT bundle). Tolerances are that file's own: f32 2e-5 of the output's
scale (other summation orders), bf16 3e-2 (every product rounds), the whole
aggregator at depth 2 to 5e-5. On-card cases of the CUDA kernel are in
tests/test_torch_kernels.py.
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfool_tpu.models.gnt import GNTAggregator as JGNTAggregator
from nerfool_tpu.models.gnt import ViewAttention as JViewAttention
from nerfool_tpu.ops.vt_kernel import fused_view_attention

from nerfool_tpu_torch import eval_adv as port_eval_adv
from nerfool_tpu_torch.engine import Evaluator
from nerfool_tpu_torch.models.convert import gnt_state_dict
from nerfool_tpu_torch.models.gnt import GNTAggregator
from nerfool_tpu_torch.ops import view_attention as va
from nerfool_tpu_torch.backbones.gnt import shade
from nerfool_tpu_torch.render.render_rays import RenderConfig

# the test tier runs several worker processes on a few cores: two math
# threads per process instead of one per core keeps them from thrashing
torch.set_num_threads(2)

V, R, S, D, F = 4, 6, 12, 64, 32


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x, np.float32)).to(dtype)


@pytest.fixture(scope="module")
def nets():
    """A flax GNT aggregator at depth 2 with its params, and the port's with
    the same weights."""
    rng = np.random.RandomState(2)
    agg_in = _agg_inputs(rng)
    mod = JGNTAggregator(in_feat_ch=F, trans_depth=2, ret_alpha=True)
    params = mod.init(jax.random.PRNGKey(3),
                      *(jnp.asarray(a) for a in agg_in))["params"]
    net = GNTAggregator(in_feat_ch=F, trans_depth=2, ret_alpha=True)
    net.load_state_dict(gnt_state_dict(jax.tree.map(np.asarray, params)))
    return mod, params, net.requires_grad_(False)


def _agg_inputs(rng, v=V, r=R, s=S):
    f = lambda *shape: rng.randn(*shape).astype(np.float32)
    mask = (rng.rand(v, r, s, 1) > 0.2).astype(np.float32)
    return f(v, r, s, 3 + F), f(v, r, s, 4), mask, f(r, s, 3), f(r, 3)


def _va_inputs(rng, v=V, r=R, s=16, masked_ray=False):
    """q, k, pos, mask as numpy, views-first; ``masked_ray``: every view of
    ray 0 masked."""
    f = lambda *shape: rng.randn(*shape).astype(np.float32)
    mask = (rng.rand(v, r, s, 1) > 0.2).astype(np.float32)
    if masked_ray:
        mask[:, 0] = 0.0
    return f(r, s, D), f(v, r, s, D), f(v, r, s, 4), mask


def _kernel_weights(p):
    """The flax ViewAttention params in ``fused_view_attention``'s order."""
    w = lambda name: np.asarray(p[name]["kernel"])
    b = lambda name: np.asarray(p[name]["bias"])
    wkv = np.concatenate([w("k_fc"), w("k_fc") @ w("v_fc")], axis=-1)
    return (w("q_fc"), wkv, w("pos_fc0"), b("pos_fc0"), w("pos_fc1"),
            b("pos_fc1"), w("attn_fc0"), b("attn_fc0"), w("attn_fc1"),
            b("attn_fc1"), w("out_fc"), b("out_fc"))


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max()) / (float(np.abs(ref).max()) + 1e-8)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_plain_matches_pallas_kernel_and_module(nets, dtype, tol):
    """``view_attention_plain`` and the port's module on its fused route
    (the plain version on the CPU) against the Pallas kernel in interpret
    mode and the flax module."""
    _, params, net = nets
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    p = jax.tree.map(lambda x: x.astype(jdt), params["view_trans_0"]["attn"])
    q, k, pos, mask = _va_inputs(np.random.RandomState(0))
    jin = [jnp.asarray(a, jdt) for a in (q, k, pos, mask)]
    ref_mod = JViewAttention(D).apply({"params": p}, *jin)
    ref_ker = JViewAttention(D, fused=True).apply({"params": p}, *jin)

    n = R * 16
    tin = [_t(q, tdt).reshape(n, D), _t(k, tdt).reshape(V, n, D),
           _t(pos, tdt).reshape(V, n, 4), _t(mask, tdt).reshape(V, n, 1)]
    weights = [_t(w) for w in _kernel_weights(params["view_trans_0"]["attn"])]
    before = va.view_attention.launches
    got = va.view_attention(*tin, *weights)
    assert va.view_attention.launches == before  # CPU: no launch
    assert got.dtype == tdt and got.shape == (n, D)
    got = got.float().reshape(R, 16, D).numpy()
    assert _rel_err(got, ref_ker) < tol
    assert _rel_err(got, ref_mod) < tol
    with torch.no_grad():
        mod_got = net.view_crosstrans[0].attn(
            _t(q, tdt), _t(k, tdt), _t(pos, tdt), _t(mask, tdt), fused=True)
    assert _rel_err(mod_got.float().numpy(), ref_ker) < tol


def test_fully_masked_rows_finite_and_equal(nets):
    """A ray masked in every view: the module softmaxes a uniform -1e9 row
    to 1 / V weights, and so do the Pallas kernel and the plain version."""
    _, params, net = nets
    p = params["view_trans_0"]["attn"]
    q, k, pos, mask = _va_inputs(np.random.RandomState(1), v=3, r=2, s=8,
                                 masked_ray=True)
    jin = [jnp.asarray(a) for a in (q, k, pos, mask)]
    ref = JViewAttention(D, fused=True).apply({"params": p}, *jin)
    ref_mod = JViewAttention(D).apply({"params": p}, *jin)
    with torch.no_grad():
        got = net.view_crosstrans[0].attn(_t(q), _t(k), _t(pos), _t(mask),
                                          fused=True).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(ref_mod), atol=2e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_lane_packed_odd_rows_match(nets, dtype, tol):
    """The TPU kernel's lane-packed body (``lane_pack=True``) with an odd
    row count (it pads a row): the same function, so the port's wrapper,
    which has one formulation, gives it the same answer."""
    _, params, _ = nets
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    q, k, pos, mask = _va_inputs(np.random.RandomState(7), v=4, r=3, s=5)
    n = 15
    flat = (q.reshape(n, D), k.reshape(4, n, D), pos.reshape(4, n, 4),
            mask.reshape(4, n, 1))
    w = _kernel_weights(params["view_trans_1"]["attn"])
    ref = fused_view_attention(*(jnp.asarray(a, jdt) for a in flat),
                               *(jnp.asarray(a, jdt) for a in w),
                               lane_pack=True)
    got = va.view_attention(*(_t(a, tdt) for a in flat),
                            *(_t(a) for a in w))
    assert got.shape == (n, D)
    assert _rel_err(got.float().numpy(), ref) < tol


def test_f64_keeps_the_module_path(nets, monkeypatch):
    """float64 input never reaches the kernel's wrapper: the fused route
    equals the module path bit for bit."""
    _, _, net = nets

    def boom(*a, **k):
        raise AssertionError("view_attention called on float64 input")

    monkeypatch.setattr(va, "view_attention", boom)
    net64 = GNTAggregator(in_feat_ch=F, trans_depth=2).double()
    net64.load_state_dict({k: v.double() for k, v in net.state_dict().items()})
    q, k, pos, mask = (_t(a, torch.float64) for a in _va_inputs(
        np.random.RandomState(4), v=3, r=2, s=8))
    attn = net64.view_crosstrans[0].attn
    with torch.no_grad():
        got = attn(q, k, pos, mask, fused=True)
        ref = attn(q, k, pos, mask)
    assert got.dtype == torch.float64
    assert torch.equal(got, ref)


@pytest.mark.parametrize("lane_pack", [False, True])
def test_fused_aggregator_matches_plain_and_jax(nets, lane_pack, monkeypatch):
    """The whole aggregator at depth 2 with ``fused_attn`` and ``fused_vt``
    against its own module path, and against the JAX aggregator through both
    Pallas kernels in interpret mode (``lane_pack``: the JAX view-attention
    kernel's lane-packed body, the same function)."""
    mod, params, net = nets
    inputs = _agg_inputs(np.random.RandomState(5))
    jref = mod.clone(fused_attn=True, fused_vt=True,
                     fused_vt_lp=lane_pack).apply(
        {"params": params}, *(jnp.asarray(a) for a in inputs))
    tin = [_t(a) for a in inputs]
    launches = va.view_attention.launches
    calls = []
    real = va.view_attention
    monkeypatch.setattr(va, "view_attention",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    with torch.no_grad():
        ref = net(*tin)
        assert not calls
        got = net(*tin, fused_attn=True, fused_vt=True)
    assert len(calls) == 2  # one per depth, through the wrapper
    assert real.launches == launches  # CPU: no launch
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), atol=5e-5,
                               rtol=1e-4)


def test_fused_route_raises_under_grad(nets):
    """The kernel has no backward: with grad mode on and an operand that
    requires grad the fused route raises instead of detouring."""
    _, _, net = nets
    inputs = [_t(a) for a in _agg_inputs(np.random.RandomState(6))]
    inputs[0].requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        net(*inputs, fused_vt=True)
    with torch.no_grad():
        assert net(*inputs, fused_vt=True).shape == (R, 3 + S)
    assert net(*inputs).requires_grad  # the module path differentiates


def test_shade_passes_the_render_configs_flags(nets, monkeypatch):
    _, _, net = nets
    seen = []
    real = va.view_attention

    def spy(*a, **k):
        seen.append(1)
        return real(*a, **k)

    monkeypatch.setattr(va, "view_attention", spy)
    inputs = [_t(a) for a in _agg_inputs(np.random.RandomState(8))]
    base = dict(n_samples=S, backbone="gnt", single_net=True)
    for fused, calls in ((False, 0), (True, net.trans_depth)):
        seen.clear()
        with torch.no_grad():
            raw = shade(RenderConfig(**base, gnt_fused_vt=fused),
                        {"net_coarse": net}, 0, *inputs)
        # the kernel's wrapper once per depth, or never
        assert len(seen) == calls and raw.shape == (R, 3 + S)


def test_evaluator_reads_the_flag_for_renders_only(tmp_path):
    """``--gnt_fused_vt`` reaches the whole-frame render config and never
    the differentiated step's; K2's bf16 route keeps precedence. ``auto``,
    the default, resolves to off on the CPU; True and False parse as on and
    off."""
    small = {"n_views": 6, "h": 48, "w": 64}
    argv = ["--eval_dataset", "synthetic", "--backbone", "gnt",
            "--trans_depth", "2", "--ret_alpha", "--N_samples", "12",
            "--N_importance", "0", "--chunk_size", "256",
            "--num_source_views", "4", "--rootdir", str(tmp_path), "--device",
            "cpu", "--dataset_kwargs", json.dumps(small), "--use_bspg",
            "False", "--gnt_fused_attack", "True"]
    assert port_eval_adv.parse_args(argv).gnt_fused_vt == "auto"
    assert port_eval_adv.parse_args(
        argv + ["--gnt_fused_vt", "False"]).gnt_fused_vt == "off"
    ev = Evaluator(port_eval_adv.parse_args(argv), dataset_kwargs=small,
                   device="cpu", seed=0)
    assert not ev.view_render_cfg(4).gnt_fused_vt
    args = port_eval_adv.parse_args(argv + ["--gnt_fused_vt", "True"])
    assert args.gnt_fused_vt == "on"
    ev = Evaluator(args, dataset_kwargs=small, device="cpu", seed=0)
    assert ev.view_render_cfg(4).gnt_fused_vt
    grad_cfg = ev._grad_render_cfg()
    assert grad_cfg.gnt_fused_attn and not grad_cfg.gnt_fused_vt
    data = ev.test_dataset[0]
    src = ev._make_src(data)
    with torch.inference_mode():
        fused = ev.render_view(data, src)["outputs_coarse"]
        ev.args.gnt_fused_vt = False
        plain = ev.render_view(data, src)["outputs_coarse"]
    for k, tol in (("rgb", 1e-5), ("depth", 2e-5), ("weights", 1e-6)):
        assert float((fused[k] - plain[k]).abs().max()) <= tol, k
    # bf16 with the chain: the chain kernel's route, not the view attention's
    args = port_eval_adv.parse_args(argv + [
        "--gnt_fused_vt", "True", "--compute_dtype", "bfloat16",
        "--gnt_fused_chain", "on"])
    ev = Evaluator(args, dataset_kwargs=small, device="cpu", seed=0)
    cfg = ev.view_render_cfg(4)
    assert cfg.gnt_fused_chain and cfg.gnt_fused_vt
    calls = []
    import nerfool_tpu_torch.ops.chain as chain
    real = chain.fused_chain_aggregate
    try:
        chain.fused_chain_aggregate = lambda *a, **k: (
            calls.append(1), real(*a, **k))[1]
        with torch.inference_mode():
            ev.render_view(ev.test_dataset[0],
                           ev._make_src(ev.test_dataset[0]))
    finally:
        chain.fused_chain_aggregate = real
    assert calls
