"""Whole-frame IBRNet render of the port against the JAX package's
``render_single_image`` on the same weights, cameras and BSPG plan.

Coarse level: both run float32 through the same plan; the feature net and
aggregator differ only in summation order (~1e-5 of the feature scale, see
test_torch_models), which reaches the composited rgb as ~1e-5: held to
2e-4 absolute, depth to 1e-3 on depths of 1-8. The fine level resamples
by inverse CDF, where a last-ulp weight difference can move a depth to the
neighbouring bin (inverse-CDF chaos, not a fault); fine outputs are compared
on the rays whose fine depths agree to 1e-5, which must be nearly all.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers import llff_rig_scene

from nerfool_tpu.models.bundle import create_model as j_create_model
from nerfool_tpu.ops.bspg import plan_render_specs as j_plan
from nerfool_tpu.render.render_image import render_single_image as j_render
from nerfool_tpu.render.render_rays import RenderConfig as JConfig
from nerfool_tpu.utils.cameras import get_rays as j_get_rays

from nerfool_tpu_torch.models.bundle import create_model
from nerfool_tpu_torch.models.convert import params_from_flax
from nerfool_tpu_torch.ops.bspg import plan_render_specs
from nerfool_tpu_torch.render.render_image import render_single_image
from nerfool_tpu_torch.render.render_rays import RenderConfig
from nerfool_tpu_torch.utils.cameras import get_rays

# the test tier runs several worker processes on a few cores: two math
# threads per process instead of one per core keeps them from thrashing
torch.set_num_threads(2)

H = W = 32
BLOCK = (4, 4)
N_S, N_I = 12, 8


@pytest.fixture(scope="module")
def renders():
    rng = np.random.RandomState(11)
    target_cam, src_rgbs, src_cams, _, depth_range = llff_rig_scene(
        rng, n_src=3, h=H, w=W)
    jb = j_create_model(backbone="ibrnet", rng_key=jax.random.PRNGKey(3))
    jfeats = jb.extract_features(jnp.asarray(src_rgbs))
    intr = target_cam[2:18].reshape(4, 4)
    c2w = target_cam[18:34].reshape(4, 4)
    rays_o, rays_d = j_get_rays(H, W, jnp.asarray(intr), jnp.asarray(c2w))
    jbatch = {"ray_o": rays_o, "ray_d": rays_d,
              "depth_range": jnp.asarray(depth_range),
              "camera": jnp.asarray(target_cam[None])}
    jspecs = j_plan(target_cam[None], src_cams, depth_range.reshape(-1),
                    (H, W), jfeats[0].shape[1:3], block=BLOCK, windows=False)
    assert jspecs is not None
    jcfg = JConfig(n_samples=N_S, n_importance=N_I, det=True,
                   backbone="ibrnet", bspg_specs=jspecs, bspg_pallas=False,
                   bspg_window=False)
    ref = j_render(jb.render_params, jb.modules, jbatch, jfeats, jcfg, h=H,
                   w=W, src_rgbs=jnp.asarray(src_rgbs),
                   src_cameras=jnp.asarray(src_cams), chunk_size=256)
    ref = jax.tree.map(np.asarray, ref)

    tb = create_model(state_dicts=params_from_flax(
        jax.tree.map(np.asarray, jb.params)))
    t = lambda x: torch.as_tensor(np.array(x))
    specs = plan_render_specs(target_cam[None], src_cams,
                              depth_range.reshape(-1), (H, W),
                              tuple(jfeats[0].shape[1:3]), block=BLOCK)
    cfg = RenderConfig(n_samples=N_S, n_importance=N_I, bspg_specs=specs)
    ro, rd = get_rays(H, W, t(intr), t(c2w))
    batch = {"ray_o": ro, "ray_d": rd, "depth_range": t(depth_range),
             "camera": t(target_cam[None])}
    with torch.no_grad():
        feats = tb.extract_features(t(src_rgbs))
        kw = dict(h=H, w=W, src_rgbs=t(src_rgbs), src_cameras=t(src_cams),
                  chunk_size=256)
        out = render_single_image(tb.nets, batch, feats, cfg, **kw)
        out_tap = render_single_image(
            tb.nets, batch, feats, dataclasses.replace(cfg, bspg_specs=None),
            **kw)
    return ref, out, out_tap


def _np(level):
    return {k: v.numpy() for k, v in level.items()}


def test_coarse_matches_jax(renders):
    ref, out, _ = renders
    c, rc = _np(out["outputs_coarse"]), ref["outputs_coarse"]
    np.testing.assert_array_equal(c["mask"], rc["mask"])
    np.testing.assert_allclose(c["rgb"], rc["rgb"], rtol=0, atol=2e-4)
    np.testing.assert_allclose(c["depth"], rc["depth"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(c["weights"], rc["weights"], rtol=0, atol=2e-4)


def test_fine_matches_jax_where_depths_agree(renders):
    ref, out, _ = renders
    f, rf = _np(out["outputs_fine"]), ref["outputs_fine"]
    same = np.isclose(f["z_vals"], rf["z_vals"], rtol=1e-5, atol=0).all(-1)
    assert same.mean() > 0.95, same.mean()
    np.testing.assert_allclose(f["rgb"][same], rf["rgb"][same], rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(f["depth"][same], rf["depth"][same], rtol=0,
                               atol=1e-3)


def test_bspg_matches_per_tap_route(renders):
    """Within the port, BSPG selection == the F.grid_sample per-tap route on
    the same weights (exact reconstruction; f32 sum order only)."""
    _, out, tap = renders
    for lvl in ("outputs_coarse", "outputs_fine"):
        np.testing.assert_allclose(out[lvl]["rgb"].numpy(),
                                   tap[lvl]["rgb"].numpy(), rtol=0, atol=2e-5)
        np.testing.assert_allclose(out[lvl]["depth"].numpy(),
                                   tap[lvl]["depth"].numpy(), rtol=0,
                                   atol=1e-4)
