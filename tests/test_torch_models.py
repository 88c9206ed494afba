"""Port networks against the flax reference on the same weights: the JAX
bundle's params go through ``convert.params_from_flax`` into the port.

Tolerances: both sides run float32 (the port with TF32 off); the ResUNet's
16 conv/InstanceNorm stages and the aggregator's MLP/attention stack differ
only in summation order, held to 1e-5 relative (1e-5 absolute near zero).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfool_tpu.models.bundle import create_model as j_create_model
from nerfool_tpu.models import torch_port

from nerfool_tpu_torch.models.bundle import create_model
from nerfool_tpu_torch.models.convert import params_from_flax
from nerfool_tpu_torch.models.resunet import feature_hw

# the test tier runs several worker processes on a few cores: two math
# threads per process instead of one per core keeps them from thrashing
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jbundle():
    return j_create_model(backbone="ibrnet", rng_key=jax.random.PRNGKey(3))


@pytest.fixture(scope="module")
def state_dicts(jbundle):
    return params_from_flax(jax.tree.map(np.asarray, jbundle.params))


def test_precision_pinned():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
            is False)


def test_state_dicts_round_trip_through_torch_port(jbundle, state_dicts):
    """params_from_flax is the exact inverse of the reference-checkpoint
    importer, so the port's modules carry the reference key layout."""
    back = {
        "feature_net": torch_port.resunet_params_from_torch(
            state_dicts["feature_net"]),
        "net_coarse": torch_port.ibrnet_params_from_torch(
            state_dicts["net_coarse"]),
        "net_fine": torch_port.ibrnet_params_from_torch(
            state_dicts["net_fine"]),
    }
    ref = jax.tree.map(np.asarray, jbundle.params)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a).reshape(b.shape), b)


def test_resunet_matches_flax(rng, jbundle, state_dicts):
    x = rng.rand(2, 40, 52, 3).astype(np.float32)
    jc, jf = jbundle.extract_features(jnp.asarray(x))
    tb = create_model(state_dicts=state_dicts)
    with torch.no_grad():
        tc, tf = tb.extract_features(torch.as_tensor(x))
    assert tuple(tc.shape[1:3]) == feature_hw(40, 52)
    # through 16 InstanceNorm stages each f32 run lands ~1.3e-5 of the
    # output scale from a float64 run of the same net, so the two are held
    # to 2e-5 of that scale (and 1e-5 relative)
    for a, b in ((jc, tc), (jf, tf)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5,
                                   atol=2e-5 * np.abs(a).max())


@pytest.mark.parametrize("net", ["net_coarse", "net_fine"])
def test_ibrnet_aggregator_matches_flax(rng, jbundle, state_dicts, net):
    v, r, s = 4, 6, 16
    rgb_feat = rng.randn(v, r, s, 35).astype(np.float32)
    ray_diff = rng.randn(v, r, s, 4).astype(np.float32)
    ray_diff[..., 3] = np.tanh(ray_diff[..., 3])
    mask = (rng.rand(v, r, s, 1) > 0.3).astype(np.float32)
    mask[:, 0, :3] = 0.0  # samples seen by no view: sigma forced to 0
    ref = getattr(jbundle, net).apply(
        {"params": jbundle.params[net]}, jnp.asarray(rgb_feat),
        jnp.asarray(ray_diff), jnp.asarray(mask))
    tb = create_model(state_dicts=state_dicts)
    with torch.no_grad():
        out = getattr(tb, net)(torch.as_tensor(rgb_feat),
                               torch.as_tensor(ray_diff),
                               torch.as_tensor(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_seeded_init_is_reproducible():
    a = create_model(seed=5).net_coarse.state_dict()
    b = create_model(seed=5).net_coarse.state_dict()
    c = create_model(seed=6).net_coarse.state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["base_fc.0.weight"], c["base_fc.0.weight"])


@pytest.mark.parametrize("hw", [(24, 32), (37, 50), (48, 64)])
def test_feature_hw_matches_forward(hw):
    net = create_model(seed=0, coarse_only=True).feature_net
    with torch.no_grad():
        out, _ = net(torch.zeros((1,) + hw + (3,)))
    assert tuple(out.shape[1:3]) == feature_hw(*hw)
