"""The port's GNT modules and whole-chain aggregation against the flax
reference on the same weights (``convert.params_from_flax``), on the CPU.

Tolerances: f32 on both sides differs in summation order only. The
aggregator and the plain chain land within ~5e-7 of outputs of scale ~1,
held to 1e-5 of the output scale; the ResUNet as in test_torch_models. The
JAX chain kernel runs in Pallas interpret mode, as its own tests run it.
In bf16 both packages round at every product, in other orders, so a bf16
comparison is held to a bound derived from the JAX bf16 run's own error
against the f32 run on the same inputs: the port's may be at most twice it.
"""
import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfool_tpu.data.synthetic import SyntheticDataset
from nerfool_tpu.models.bundle import create_model as j_create_model
from nerfool_tpu.models import torch_port
from nerfool_tpu.ops import bspg as j_bspg
from nerfool_tpu.ops.chain_kernel import (
    fused_chain_aggregate as j_fused_chain_aggregate,
    fused_gnt_chain as j_fused_gnt_chain,
)

from nerfool_tpu_torch.models.bundle import create_model
from nerfool_tpu_torch.ops import bspg as t_bspg
from nerfool_tpu_torch.models.convert import gnt_state_dict, params_from_flax
from nerfool_tpu_torch.models.gnt import GNTAggregator
from nerfool_tpu_torch.ops import chain
from nerfool_tpu_torch.backbones.gnt import shade
from nerfool_tpu_torch.render.render_rays import RenderConfig

REL = 1e-5  # f32, relative to the output scale


@pytest.fixture(scope="module")
def jbundle():
    return j_create_model(backbone="gnt", trans_depth=3, single_net=True,
                          rng_key=jax.random.PRNGKey(5))


@pytest.fixture(scope="module")
def state_dicts(jbundle):
    return params_from_flax(jax.tree.map(np.asarray, jbundle.params))


def _inputs(rng, v=4, r=6, s=24, f=32, masked_ray=False):
    """The operand shapes of tests/test_chain_kernel.py, as numpy."""
    rf = rng.randn(v, r, s, 3 + f).astype(np.float32)
    rd = rng.randn(v, r, s, 4).astype(np.float32)
    m = (rng.rand(v, r, s, 1) > 0.2).astype(np.float32)
    if masked_ray:
        m[:, 0] = 0.0  # every view masked out for ray 0
    pts = rng.randn(r, s, 3).astype(np.float32)
    rayd = rng.randn(r, 3).astype(np.float32)
    return rf, rd, m, pts, rayd


def _net(params, depth, ret_alpha=True):
    net = GNTAggregator(32, 64, depth, ret_alpha=ret_alpha)
    net.load_state_dict(gnt_state_dict(jax.tree.map(np.asarray, params)))
    return net.eval()


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(1.0, float(np.abs(ref).max())), err


def test_gnt_state_dict_round_trip(jbundle, state_dicts):
    """gnt_state_dict is the exact inverse of the reference importer; a
    single_net bundle has no net_fine."""
    assert set(state_dicts) == {"feature_net", "net_coarse"}
    back = {
        "feature_net": torch_port.resunet_params_from_torch(
            state_dicts["feature_net"]),
        "net_coarse": torch_port.gnt_params_from_torch(
            state_dicts["net_coarse"], trans_depth=3),
    }
    ref = jax.tree.map(np.asarray, jbundle.params)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a).reshape(b.shape), b)
    # the port's modules carry exactly the reference keys
    tb = create_model(backbone="gnt", trans_depth=3, single_net=True)
    assert set(tb.net_coarse.state_dict()) == set(state_dicts["net_coarse"])
    assert tb.net_fine is None and tb.nets["net_fine"] is tb.net_coarse


def test_resunet_single_net_matches_flax(rng, jbundle, state_dicts):
    x = rng.rand(2, 40, 52, 3).astype(np.float32)
    jc, jf = jbundle.extract_features(jnp.asarray(x))
    tb = create_model(backbone="gnt", trans_depth=3, single_net=True,
                      state_dicts=state_dicts)
    with torch.no_grad():
        tc, tf = tb.extract_features(torch.as_tensor(x))
    assert tc is tf and tc.shape[-1] == 32  # one head serves both levels
    a = np.asarray(jc)
    np.testing.assert_allclose(tc.numpy(), a, rtol=1e-5,
                               atol=2e-5 * np.abs(a).max())


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("ret_alpha", [True, False])
def test_gnt_aggregator_matches_flax(depth, ret_alpha):
    rng = np.random.RandomState(depth)
    args = _inputs(rng, r=5, s=13, masked_ray=True)
    jb = j_create_model(backbone="gnt", trans_depth=depth, single_net=True,
                        rng_key=jax.random.PRNGKey(depth))
    mod = jb.net_coarse.clone(ret_alpha=ret_alpha)
    ref = mod.apply({"params": jb.params["net_coarse"]},
                    *map(jnp.asarray, args))
    net = _net(jb.params["net_coarse"], depth, ret_alpha)
    with torch.no_grad():
        out = net(*map(torch.as_tensor, args))
    assert out.shape == (5, 3 + 13 if ret_alpha else 3)
    _close(out, ref)


def _jax_params(depth, seed=1):
    from nerfool_tpu.models.gnt import GNTAggregator as JGNT

    mod = JGNT(in_feat_ch=32, netwidth=64, trans_depth=depth, ret_alpha=True)
    args = _inputs(np.random.RandomState(0))
    return mod.init(jax.random.PRNGKey(seed),
                    *map(jnp.asarray, args))["params"]


@pytest.mark.parametrize("depth,r,s,masked", [(2, 6, 24, False),
                                              (3, 6, 24, False),
                                              (2, 5, 13, False),
                                              (2, 6, 24, True)])
def test_plain_chain_matches_jax_chain_kernel(depth, r, s, masked):
    """gnt_chain_plain's (q, attn0) and fused_chain_aggregate against the
    JAX chain kernel (interpret mode) at f32: R not a multiple of the JAX ray
    tile, S not a multiple of 8 (padded keys get no weight there), and a ray
    with every view masked (finite, uniform view weights)."""
    params = _jax_params(depth)
    args = _inputs(np.random.RandomState(10 + depth), r=r, s=s,
                   masked_ray=masked)
    net = _net(params, depth)
    targs = tuple(map(torch.as_tensor, args))
    with torch.no_grad():
        merged, emb = chain.chain_inputs(net, *targs)
        q, attn0 = chain.gnt_chain_plain(net, merged, emb)
        out = chain.fused_chain_aggregate(net, *targs)
    pe = emb.shape[-1] // 2
    jq, ja = j_fused_gnt_chain(
        params, *map(jnp.asarray, args[:3]), jnp.asarray(emb[..., :pe]),
        jnp.asarray(emb[..., pe:]), depth=depth, rays_tile=4)
    ref = j_fused_chain_aggregate(params, *map(jnp.asarray, args),
                                  depth=depth, rays_tile=4)
    _close(q, jq)
    _close(attn0, ja)
    _close(out, ref)
    assert bool(torch.isfinite(out).all())


def test_plain_chain_bf16_within_derived_bound():
    """bf16: the port's chain against the JAX chain kernel (interpret), both
    held to the JAX f32 run on the same inputs."""
    depth = 2
    params = _jax_params(depth)
    args = _inputs(np.random.RandomState(7))
    ref = np.asarray(j_fused_chain_aggregate(
        params, *map(jnp.asarray, args), depth=depth, rays_tile=4))
    pb = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    jb = j_fused_chain_aggregate(
        pb, *[jnp.asarray(a, jnp.bfloat16) for a in args], depth=depth,
        rays_tile=4)
    net = _net(params, depth)
    with torch.no_grad():
        out = chain.fused_chain_aggregate(
            net, *[torch.as_tensor(a).bfloat16() for a in args])
    assert out.dtype == torch.bfloat16
    err_j = float(np.abs(np.asarray(jb, np.float32) - ref).max())
    err_t = float(np.abs(out.float().numpy() - ref).max())
    assert err_t <= 2.0 * err_j, (err_t, err_j)


def test_shade_routes_chain_only_in_bf16():
    """The shade takes the chain for bf16 with gnt_fused_chain, as JAX's
    make_shade_fn does; f32 keeps the module path bit for bit."""
    rng = np.random.RandomState(3)
    args = tuple(map(torch.as_tensor, _inputs(rng)))
    net = create_model(backbone="gnt", trans_depth=2, seed=2).net_coarse
    nets = {"net_coarse": net, "net_fine": net}
    cfg = RenderConfig(backbone="gnt", gnt_fused_chain=True)
    with torch.no_grad():
        a = shade(cfg, nets, 0, *args)
        b = net(*args)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        bf = RenderConfig(backbone="gnt", gnt_fused_chain=True,
                          compute_dtype="bfloat16")
        before = chain.gnt_chain.launches
        got = shade(bf, nets, 0, *args)
        assert got.dtype == torch.float32  # promoted back
        ref = chain.fused_chain_aggregate(
            net, *(t.bfloat16() for t in args)).float()
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        assert chain.gnt_chain.launches == before  # CPU: plain version


@pytest.mark.parametrize("planner", [j_bspg, t_bspg], ids=["jax", "torch"])
def test_slice_rig_rejects_8x8_blocks_at_stride_2(planner):
    """The GNT slice's camera set (the synthetic orbit rig, 15 views at
    378x504) at gnt_full's render_stride 2: an 8x8 ray block spans 15
    pixels, and the rgb table's tube radius then exceeds every patch size
    plan_render_specs admits, in the JAX planner and the port's alike. So
    plan_render_specs returns None there, and the slice plans 4x4 blocks."""
    ds = SyntheticDataset(None, "test", n_views=15, h=378, w=504)
    cams, dr = ds.target_cameras()
    cams, dr = np.asarray(cams, np.float64), np.asarray(dr, np.float64)
    rgb_ps = inspect.signature(planner.plan_render_specs).parameters[
        "rgb_ps"].default
    for p in rgb_ps:
        with pytest.raises(ValueError, match="tube radius"):
            planner.plan_block_groups(cams, cams, dr, (378, 504), p,
                                      block=(8, 8), render_stride=2)
