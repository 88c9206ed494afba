"""Port BSPG (planner, slot walk, tap selection from the patch table)
against the JAX package. The CUDA kernel's own tests are in test_torch_kernels.py.

The planner and slot walk must agree exactly (plans and integer slot ids).
Selection is exact bilinear reconstruction, so it is held at float32 to
rtol 1e-5 / atol 1e-6 against the JAX XLA selection (``_select_group_xla``),
the Pallas selection kernels in interpret mode, and the per-tap
``F.grid_sample`` oracle.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from helpers import llff_rig_scene
from test_bspg import _realized_spans, _setup_win

from nerfool_tpu.data.synthetic import SyntheticDataset
from nerfool_tpu.ops import bspg as jbspg
from nerfool_tpu.ops.bspg_kernel import KB as J_KB
from nerfool_tpu.ops.spg import project_endpoints as j_project_endpoints
from nerfool_tpu.render.projection import project_points_planes as j_project
from nerfool_tpu.render.sampling import sample_along_camera_ray as j_sample
from nerfool_tpu.utils.cameras import get_rays as j_get_rays

from nerfool_tpu_torch.models.resunet import feature_hw
from nerfool_tpu_torch.ops import bspg
from nerfool_tpu_torch.ops.spg import pack_patch_table
from nerfool_tpu_torch.render.projection import gather_bilinear_planes

# the test tier runs several worker processes on a few cores: two math
# threads per process instead of one per core keeps them from thrashing
torch.set_num_threads(2)

H = W = 32
BLOCK = (4, 4)


def _t(x):
    return torch.as_tensor(np.array(x))


def _port_spec(jspec):
    """The JAX spec's fields minus the TPU window bounds."""
    return bspg.BSPGSpec(p=jspec.p, h=jspec.h, w=jspec.w, h_full=jspec.h_full,
                         w_full=jspec.w_full, pby=jspec.pby, pbx=jspec.pbx,
                         block=tuple(jspec.block), groups=jspec.groups)


def _blocks(x, h, w, bh, bw, s):
    """[V, h*w*s] -> [V, B, bh*bw, S] in block-major ray order."""
    v = x.shape[0]
    x = np.asarray(x).reshape(v, h // bh, bh, w // bw, bw, s)
    return x.transpose(0, 1, 3, 2, 4, 5).reshape(
        v, (h // bh) * (w // bw), bh * bw, s)


def _table_from_rows(g_groups, slots_groups, spec, c):
    """A patch table holding the gathered rows G at their slot ids (rows no
    slot names stay zero: the selection never reads them)."""
    v = sum(len(views) for views, _ in spec.groups)
    table = np.zeros((v, spec.pby * spec.pbx, (spec.p + 1) ** 2 * c),
                     np.float32)
    for (views, _), g, slots in zip(spec.groups, g_groups, slots_groups):
        g, slots = np.asarray(g), np.asarray(slots)
        for i, view in enumerate(views):
            ok = slots[i] >= 0
            table[view, slots[i][ok]] = g[i][ok]
    return _t(table)


@pytest.fixture(scope="module")
def scene():
    """32x32 forward-facing rig, 4 source views, 4x4 blocks, p=12: the JAX
    test_bspg fixture. Returns numpy inputs both packages share."""
    rng = np.random.RandomState(7)
    target_cam, _, src_cams, _, depth_range = llff_rig_scene(
        rng, n_src=4, h=H, w=W)
    intr = target_cam[2:18].reshape(4, 4)
    c2w = target_cam[18:34].reshape(4, 4)
    rays_o, rays_d = j_get_rays(H, W, jnp.asarray(intr), jnp.asarray(c2w))
    pts, _ = j_sample(rays_o, rays_d, jnp.asarray(depth_range), 12, det=True)
    ro = np.asarray(rays_o).reshape(H // 4, 4, W // 4, 4, 3).transpose(
        0, 2, 1, 3, 4).reshape(-1, 16, 3)
    rd = np.asarray(rays_d).reshape(H // 4, 4, W // 4, 4, 3).transpose(
        0, 2, 1, 3, 4).reshape(-1, 16, 3)
    cidx = np.array([0, 3, 12, 15])
    near, far = float(depth_range[0, 0]), float(depth_range[0, 1])
    pa, pb = j_project_endpoints(
        jnp.asarray((ro[:, cidx] + rd[:, cidx] * near).reshape(-1, 3)),
        jnp.asarray((ro[:, cidx] + rd[:, cidx] * far).reshape(-1, 3)),
        jnp.asarray(src_cams))
    v, b = src_cams.shape[0], ro.shape[0]
    px, py, _ = j_project(pts.reshape(-1, 3), jnp.asarray(src_cams))
    s = pts.shape[1]
    gx = _blocks(2.0 * np.asarray(px) / (W - 1.0) - 1.0, H, W, 4, 4, s)
    gy = _blocks(2.0 * np.asarray(py) / (H - 1.0) - 1.0, H, W, 4, 4, s)
    groups, _ = jbspg.plan_block_groups(
        target_cam[None], src_cams, depth_range.reshape(-1), (H, W), p=12,
        block=BLOCK)
    jspec = jbspg.make_block_spec(groups, 12, (H, W), (H, W), block=BLOCK)
    return dict(target_cam=target_cam, src_cams=src_cams,
                depth_range=depth_range, jspec=jspec,
                pa=np.asarray(pa).reshape(v, b, 4, 3),
                pb=np.asarray(pb).reshape(v, b, 4, 3), gx=gx, gy=gy)


def test_planner_constants_match():
    assert bspg.KB == J_KB


def test_plan_render_specs_identical_llff(scene):
    args = (scene["target_cam"][None], scene["src_cams"],
            scene["depth_range"].reshape(-1), (H, W), (H // 2, W // 2))
    ref = jbspg.plan_render_specs(*args, block=BLOCK, windows=False)
    out = bspg.plan_render_specs(*args, block=BLOCK)
    assert ref is not None
    assert out == tuple(_port_spec(r) for r in ref)


def test_plan_render_specs_identical_synthetic():
    """The eval fixture's camera set (synthetic, 6 views at 48x64), planned
    over every camera as the evaluators do, 8x8 blocks."""
    ds = SyntheticDataset(None, "test", n_views=6, h=48, w=64)
    cams, dr = ds.target_cameras()
    args = (cams, cams, dr, (48, 64), feature_hw(48, 64))
    ref = jbspg.plan_render_specs(*args, windows=False)
    out = bspg.plan_render_specs(*args)
    assert ref is not None
    assert out == tuple(_port_spec(r) for r in ref)


def test_build_block_slots_identical(scene):
    jspec = scene["jspec"]
    ref = jbspg.build_block_slots(jnp.asarray(scene["pa"]),
                                  jnp.asarray(scene["pb"]), jspec)
    out = bspg.build_block_slots(_t(scene["pa"]), _t(scene["pb"]),
                                 _port_spec(jspec))
    assert len(out) == len(ref)
    for a, b in zip(ref, out):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("c", [3, 32])
def test_select_matches_xla_and_per_tap(scene, c):
    """Port chain (pack, walk, selection through the slot ids) == the JAX
    XLA selection on its gathered rows == the per-tap F.grid_sample
    gather."""
    rng = np.random.RandomState(c)
    images = rng.rand(4, H, W, c).astype(np.float32)
    jspec, spec = scene["jspec"], _port_spec(scene["jspec"])
    jslots = jbspg.build_block_slots(jnp.asarray(scene["pa"]),
                                     jnp.asarray(scene["pb"]), jspec)
    jtab = jbspg.pack_patch_table(jnp.asarray(images), jspec.p)
    jg = jbspg.gather_block_patches(jtab, jslots, jspec)
    ref = np.asarray(jbspg.select_block_samples(
        jg, jslots, jnp.asarray(scene["gx"]), jnp.asarray(scene["gy"]),
        jspec, c))

    tab = pack_patch_table(_t(images), spec.p)
    np.testing.assert_array_equal(tab.numpy(), np.asarray(jtab))
    slots = bspg.build_block_slots(_t(scene["pa"]), _t(scene["pb"]), spec)
    out = bspg.select_block_samples(tab, slots, _t(scene["gx"]),
                                    _t(scene["gy"]), spec, c)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)

    v, b, n, s = scene["gx"].shape
    oracle = gather_bilinear_planes(_t(images), _t(scene["gx"]).reshape(v, -1),
                                    _t(scene["gy"]).reshape(v, -1))
    np.testing.assert_allclose(out.numpy(), oracle.reshape(out.shape).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_select_matches_pallas_full_width(scene):
    """Against the full-width Pallas kernel (select_block_pallas_smallc, the
    K1b route) run in interpret mode."""
    rng = np.random.RandomState(1)
    images = rng.rand(4, H, W, 3).astype(np.float32)
    jspec = scene["jspec"]
    jslots = jbspg.build_block_slots(jnp.asarray(scene["pa"]),
                                     jnp.asarray(scene["pb"]), jspec)
    jtab = jbspg.pack_patch_table(jnp.asarray(images), jspec.p)
    jg = jbspg.gather_block_patches(jtab, jslots, jspec)
    ref = jbspg.select_block_samples(
        jg, jslots, jnp.asarray(scene["gx"]), jnp.asarray(scene["gy"]),
        jspec, 3, use_pallas=True)
    out = bspg.select_block_samples(
        _t(jtab), [_t(s) for s in jslots], _t(scene["gx"]),
        _t(scene["gy"]), _port_spec(jspec), 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("c", [3, 32])
def test_select_matches_windowed_pallas(c):
    """Against the windowed Pallas selection (select_win_smallc, K1a, in
    interpret mode) on the JAX test fixture where windows are genuinely
    narrower than the slot list; 8 blocks keep interpret mode short."""
    rng = np.random.RandomState(1234)
    jspec, g, slots, starts, gxb, gyb, _, _ = _setup_win(rng, c=c, h=64, w=64,
                                                         b_take=8)
    sblk = 64 if c == 3 else 128
    spans = _realized_spans(jspec, starts, gxb, gyb, sblk)
    kw = max(-(-(3 * sp + 18) // J_KB) * J_KB for sp in spans)
    dbg = []
    ref = jbspg.select_block_samples_win(g, slots, starts, gxb, gyb, jspec, c,
                                         kw_override=kw, sblk_override=sblk,
                                         debug=dbg)
    assert any(k < ks for k, ks, _ in dbg), dbg
    out = bspg.select_block_samples(
        _table_from_rows(g, slots, jspec, c), [_t(x) for x in slots],
        _t(gxb), _t(gyb), _port_spec(jspec), c)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_select_counts_repeats_pads_misses_and_edges(scene):
    """The selection through the slot ids against the JAX XLA selection on
    its gathered rows, on slot lists edited to hold a repeated id (counted
    twice), -1 pads and ids no sample taps (so some samples' pids are in no
    slot), with a quarter of the samples moved past the image's edges."""
    rng = np.random.RandomState(5)
    c = 3
    images = rng.rand(4, H, W, c).astype(np.float32)
    jspec, spec = scene["jspec"], _port_spec(scene["jspec"])
    slots = [np.array(x) for x in jbspg.build_block_slots(
        jnp.asarray(scene["pa"]), jnp.asarray(scene["pb"]), jspec)]
    for x in slots:
        x[..., 1] = x[..., 0]       # repeated: the first id counts twice
        x[..., 2] = -1              # a pad inside the list
        x[..., 3] = jspec.pby * jspec.pbx - 1  # the grid's last patch
        x[..., 4:7] = -1            # drops three ids: their taps miss
    gx, gy = np.array(scene["gx"]), np.array(scene["gy"])
    off = rng.rand(*gx.shape) < 0.25
    gx[off] *= 1.3
    gy[off] = np.sign(gy[off]) * (1.0 + rng.rand(int(off.sum())))
    jtab = jbspg.pack_patch_table(jnp.asarray(images), jspec.p)
    jslots = [jnp.asarray(x) for x in slots]
    ref = np.asarray(jbspg.select_block_samples(
        jbspg.gather_block_patches(jtab, jslots, jspec), jslots,
        jnp.asarray(gx), jnp.asarray(gy), jspec, c))
    out = bspg.select_block_samples(_t(jtab), [_t(x) for x in slots], _t(gx),
                                    _t(gy), spec, c)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    # the edits matter: taps of the repeated patch doubled, others zeroed
    once = bspg.select_block_samples(
        _t(jtab), bspg.build_block_slots(_t(scene["pa"]), _t(scene["pb"]),
                                         spec), _t(gx), _t(gy), spec, c)
    ratio = out.numpy() / np.where(once.numpy() == 0, 1, once.numpy())
    assert np.isclose(ratio, 2.0).any() and (
        (out.numpy() == 0) & (once.numpy() != 0)).any()
