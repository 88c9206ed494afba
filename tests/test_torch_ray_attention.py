"""The plain versions of the ray-attention kernel (``ops/ray_attention.py``),
forward and backward, against the JAX package on the CPU, and the fused GNT
route of the port against its unfused one.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_ra_vjp.py does. Tolerances: 2e-4 (atol and rtol) against the
Pallas kernels and the flax module, that file's own bound (f32, other
summation orders); the hand-written backward formulas against torch
autograd through the plain forward in float64: 1e-10; the fused attack step
against the unfused one: loss 1e-5 relative, the gradient and the update
by chip_smoke.py's limbs (see the test). On-card cases of the CUDA kernels are in
tests/test_torch_kernels.py.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfool_tpu.models.gnt import RayAttention as JRayAttention
from nerfool_tpu.ops.ra_kernel import (
    fused_ray_attention,
    fused_ray_attention_ad,
)

from nerfool_tpu_torch.attack import attack as t_attack
from nerfool_tpu_torch.models.bundle import create_model
from nerfool_tpu_torch.models.gnt import RayAttention
from nerfool_tpu_torch.ops import ray_attention as ra
from nerfool_tpu_torch.backbones.gnt import shade
from nerfool_tpu_torch.render.render_rays import RenderConfig

# the test tier runs several worker processes on a few cores: two math
# threads per process instead of one per core keeps them from thrashing
torch.set_num_threads(2)

SHAPES = [(3, 10, 64), (2, 8, 64)]  # S=10: not a multiple of the TPU's 8
TOL = dict(atol=2e-4, rtol=2e-4)


def _case(shape, seed=0):
    """x and flax RayAttention params as numpy, plus (wqkv, wo, bo)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    mod = JRayAttention(shape[-1])
    params = mod.init(jax.random.PRNGKey(seed + 1), jnp.asarray(x),
                      ret_attn=True)["params"]
    p = jax.tree.map(np.asarray, params)
    wqkv = np.concatenate([p["q_fc"]["kernel"], p["k_fc"]["kernel"],
                           p["v_fc"]["kernel"]], axis=-1)
    return x, params, (wqkv, p["out_fc"]["kernel"], p["out_fc"]["bias"])


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_pallas_kernel_and_module(shape):
    x, params, w = _case(shape)
    out, attn0 = ra.ray_attention_plain(_t(x), *(_t(a) for a in w))
    k_out, k_attn0 = fused_ray_attention(jnp.asarray(x),
                                         *(jnp.asarray(a) for a in w))
    np.testing.assert_allclose(out.numpy(), np.asarray(k_out), **TOL)
    np.testing.assert_allclose(attn0.numpy(), np.asarray(k_attn0), **TOL)
    m_out, m_attn = JRayAttention(shape[-1]).apply(
        {"params": params}, jnp.asarray(x), ret_attn=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(m_out), **TOL)
    np.testing.assert_allclose(attn0.numpy(),
                               np.asarray(jnp.mean(m_attn, axis=1)[:, 0]),
                               **TOL)


def _jax_loss(x, wqkv, wo, bo, with_attn0):
    """The loss of tests/test_ra_vjp.py through the Pallas kernels."""
    out, attn0 = fused_ray_attention_ad(x, wqkv, wo, bo, 4, 16)
    loss = jnp.sum(jnp.sin(out))
    if with_attn0:
        loss = loss + jnp.sum(attn0 * jnp.arange(x.shape[1], dtype=x.dtype))
    return loss


@pytest.mark.parametrize("with_attn0", [True, False],
                         ids=["out_and_attn0", "out_only"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_pallas_vjp(shape, with_attn0):
    """dx, dWqkv, dWo and dbo of the plain backward against jax.grad through
    ``fused_ray_attention_ad`` (the backward Pallas kernel), under a
    cotangent that feeds both outputs and one that feeds ``out`` only."""
    x, _, w = _case(shape, seed=1)
    ref = jax.grad(_jax_loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), *(jnp.asarray(a) for a in w), with_attn0)
    tx, tw = _t(x), [_t(a) for a in w]
    out, _ = ra.ray_attention_plain(tx, *tw)
    gout = torch.cos(out)
    gattn0 = (torch.arange(shape[1], dtype=torch.float32).expand(shape[:2])
              if with_attn0 else torch.zeros(shape[:2]))
    dx, dwqkv, dwo = ra.ray_attention_bwd_plain(tx, tw[0], tw[1], gout,
                                                gattn0)
    for got, r in zip((dx, dwqkv, dwo, gout.sum((0, 1))), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("with_attn0", [True, False],
                         ids=["out_and_attn0", "out_only"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_autograd_f64(shape, with_attn0):
    """The backward formulas written out in tensor ops equal autograd
    through the plain forward, in float64 to 1e-10."""
    x, _, w = _case(shape, seed=2)
    leaves = [_t(a, torch.float64).requires_grad_() for a in (x, *w)]
    out, attn0 = ra.ray_attention_plain(*leaves)
    rng = np.random.RandomState(3)
    gout = _t(rng.randn(*shape), torch.float64)
    gattn0 = (_t(rng.randn(*shape[:2]), torch.float64) if with_attn0
              else torch.zeros(shape[:2], dtype=torch.float64))
    ref = torch.autograd.grad((out * gout).sum() + (attn0 * gattn0).sum(),
                              leaves)
    got = ra.ray_attention_bwd_plain(
        leaves[0].detach(), leaves[1].detach(), leaves[2].detach(), gout,
        gattn0)
    for g, r in zip(got + (gout.sum((0, 1)),), ref):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-10, rtol=0)


def test_autograd_function_uses_the_plain_backward_on_cpu():
    """``ray_attention`` on CPU tensors: the Function's gradients (the plain
    backward) equal autograd's through the plain forward; frozen weights get
    no gradient."""
    x, _, w = _case((3, 10, 64), seed=4)
    leaves = [_t(a).requires_grad_() for a in (x, *w)]
    out, attn0 = ra.ray_attention(*leaves)
    loss = torch.sin(out).sum() + (attn0 * torch.arange(10.0)).sum()
    got = torch.autograd.grad(loss, leaves)
    ro, ra0 = ra.ray_attention_plain(*leaves)
    ref = torch.autograd.grad(
        torch.sin(ro).sum() + (ra0 * torch.arange(10.0)).sum(), leaves)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5, rtol=1e-5)
    frozen = [leaves[0]] + [t.detach() for t in leaves[1:]]
    out, _ = ra.ray_attention(*frozen)
    dx, = torch.autograd.grad(torch.sin(out).sum(), frozen[0])
    assert dx.shape == leaves[0].shape and bool(torch.isfinite(dx).all())


def test_module_fused_route_matches_unfused():
    """``RayAttention(fused=True)`` returns (out, attn0 [R, S]) equal to the
    unfused module's output and head-mean first-query row; float64 input
    keeps the module path (the full map)."""
    torch.manual_seed(0)
    mod = RayAttention(64)
    x = torch.randn(3, 10, 64)
    out_u, attn = mod(x)
    out_f, attn0 = mod(x, fused=True)
    assert attn.shape == (3, 4, 10, 10) and attn0.shape == (3, 10)
    torch.testing.assert_close(out_f, out_u, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(attn0, attn.mean(1)[:, 0], atol=1e-6,
                               rtol=1e-5)
    _, attn64 = mod.double()(x.double(), fused=True)
    assert attn64.shape == (3, 4, 10, 10)


def test_aggregator_fused_attn_setting():
    """``GNTAggregator``'s ``fused_attn`` setting, per call and through
    ``RenderConfig.gnt_fused_attn``, gives the unfused output."""
    tb = create_model(backbone="gnt", trans_depth=2, seed=0)
    net = tb.net_coarse
    rng = np.random.RandomState(0)
    f = lambda *s: _t(rng.randn(*s).astype(np.float32))
    args = (f(3, 5, 9, 35), f(3, 5, 9, 4), (f(3, 5, 9, 1) > -1).float(),
            f(5, 9, 3), f(5, 3))
    with torch.no_grad():
        ref = net(*args)
        torch.testing.assert_close(net(*args, fused_attn=True), ref,
                                   atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(net(*args, fused_attn=False), ref,
                                   atol=0, rtol=0)
        for fused in (False, True):
            cfg = RenderConfig(backbone="gnt", single_net=True,
                               gnt_fused_attn=fused)
            raw = shade(cfg, tb.nets, 0, *args)
            torch.testing.assert_close(raw, ref, atol=1e-5 * fused,
                                       rtol=1e-5 * fused)


# Adam's first step is lr * g / (|g| + 1e-8): where |g| is within the two
# routes' rounding noise of 0 (~2e-6 of g's largest entry here) g can change
# sign and the update by up to 2 lr (one of the 6,912 entries, |g| = 8.8e-8,
# on an AVX-512 host), so the update is ill conditioned there. The routes
# are held to chip_smoke.py's limbs instead: g, read from Adam's first
# moment, at every entry to 1e-3 of its largest entry and to 1e-3 in
# relative L2; the entries with |g| at most the floor (at most half of them)
# to 1e-2 in relative L2 of that subset; the update to 2e-5 wherever |g|
# exceeds the floor, and on at least 0.999 of all entries. chip_smoke.py's
# floor, 1e-6, is 1e-2 of g's largest entry at its scale (~1e-4); this g is
# ~1e4 times larger (0.88), so the floor is that share of its largest entry
STEP_GRAD_FLOOR_REL = 1e-2


def test_gnt_attack_step_fused_matches_unfused():
    """One whole differentiated GNT attack step through the fused route (the
    autograd.Function: plain forward and hand-written backward on the CPU)
    against the unfused module path with torch autograd."""
    from helpers import synthetic_scene

    rng = np.random.RandomState(3)
    h, w = 24, 32
    target_cam, src_rgbs, src_cams, _, depth_range = synthetic_scene(
        rng, n_src=3, h=h, w=w)
    tb = create_model(backbone="gnt", trans_depth=2, single_net=True, seed=5)
    base = RenderConfig(n_samples=10, backbone="gnt", single_net=True,
                        ret_alpha=True)
    cfg = t_attack.AttackConfig(h=h, w=w, n_rand=32, use_adam=True,
                                adam_lr=1e-2)
    target = {"camera": _t(target_cam), "rgb": _t(rng.rand(h * w, 3)),
              "depth": None, "depth_range": _t(depth_range)}
    src = {"rgbs": _t(src_rgbs), "cameras": _t(src_cams),
           "featmaps_clean": None}
    state0 = t_attack.init_attack_state(torch.Generator().manual_seed(1), cfg,
                                        src["rgbs"])
    sel = t_attack.select_ray_indices(torch.Generator().manual_seed(2), cfg)
    outs = {}
    for fused in (False, True):
        rcfg = dataclasses.replace(base, gnt_fused_attn=fused)
        state, aux = t_attack.make_attack_step(tb, rcfg, cfg)(
            state0, target, src, sel=sel)
        # Adam's first moment after one step is -0.1 * gradient
        outs[fused] = (float(aux["loss"]),
                       (state["delta"] - state0["delta"]).numpy(),
                       (state["m"] / -0.1).double().numpy())
    np.testing.assert_allclose(outs[True][0], outs[False][0], rtol=1e-5)
    g_f, g_u = outs[True][2], outs[False][2]
    assert np.abs(g_f - g_u).max() <= 1e-3 * np.abs(g_u).max()
    assert np.linalg.norm(g_f - g_u) <= 1e-3 * np.linalg.norm(g_u)
    small = np.abs(g_u) <= STEP_GRAD_FLOOR_REL * np.abs(g_u).max()
    assert 0 < small.mean() <= 0.5
    assert (np.linalg.norm((g_f - g_u)[small])
            <= 1e-2 * np.linalg.norm(g_u[small]))
    diff = np.abs(outs[True][1] - outs[False][1])
    assert diff[~small].max() <= 2e-5
    assert np.mean(diff <= 2e-5) >= 0.999
    assert np.abs(outs[True][1]).max() > 0
