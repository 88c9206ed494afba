"""Port geometry, sampling, compositing and metrics against the JAX package:
the same numpy inputs go through ``nerfool_tpu`` and ``nerfool_tpu_torch``.

Tolerances: float32 on both sides with the same formulas, so differences
come from summation order and from 3x3/4x4 inverses computed by different
libraries (~1e-7 relative); geometry is held to ~1e-6 relative, pixel
coordinates (hundreds of pixels) to 1e-4 absolute.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from helpers import llff_rig_scene, synthetic_scene

from nerfool_tpu.metrics import image as jmetrics
from nerfool_tpu.ops.grid_sample import gather_bilinear_planes as j_gather
from nerfool_tpu.render import compositor as jcomp
from nerfool_tpu.render import projection as jproj
from nerfool_tpu.render import sampling as jsamp
from nerfool_tpu.utils import cameras as jcam

from nerfool_tpu_torch.metrics import image as tmetrics
from nerfool_tpu_torch.render import compositor as tcomp
from nerfool_tpu_torch.render import projection as tproj
from nerfool_tpu_torch.render import sampling as tsamp
from nerfool_tpu_torch.utils import cameras as tcam

# the test tier runs several worker processes on a few cores: two math
# threads per process instead of one per core keeps them from thrashing
torch.set_num_threads(2)

H, W = 24, 32


def _t(x):
    return torch.as_tensor(np.array(x))


def _scene(rng, kind="orbit"):
    fn = synthetic_scene if kind == "orbit" else llff_rig_scene
    return fn(rng, n_src=3, h=H, w=W)


def _rays(target_cam, stride=1):
    intr = target_cam[2:18].reshape(4, 4)
    c2w = target_cam[18:34].reshape(4, 4)
    jo, jd = jcam.get_rays(H, W, jnp.asarray(intr), jnp.asarray(c2w),
                           render_stride=stride)
    to, td = tcam.get_rays(H, W, _t(intr), _t(c2w), render_stride=stride)
    return (np.asarray(jo), np.asarray(jd)), (to.numpy(), td.numpy())


@pytest.mark.parametrize("stride", [1, 2])
def test_get_rays_and_parse_camera(rng, stride):
    target_cam = _scene(rng)[0]
    (jo, jd), (to, td) = _rays(target_cam, stride)
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-6)
    for a, b in zip(jcam.parse_camera(jnp.asarray(target_cam[None])),
                    tcam.parse_camera(_t(target_cam[None]))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_sqrt_rounds_float32_to_nearest(rng):
    """The port's float32 ``sqrt`` is the square root rounded to nearest,
    as numpy's and XLA's are: PyTorch's own float32 sqrt on the CPU is one
    unit in the last place off on some inputs in some builds, which put
    the angle features up to 2.6e-6 from JAX's where they cancel. Other
    dtypes take ``torch.sqrt`` as they are."""
    from nerfool_tpu_torch.utils.numerics import sqrt

    x = (rng.rand(100000) * 10).astype(np.float32)
    got = sqrt(torch.as_tensor(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.sqrt(x.astype(np.float64)).astype(np.float32))
    x64 = torch.as_tensor(x.astype(np.float64))
    assert torch.equal(sqrt(x64), torch.sqrt(x64))


@pytest.mark.parametrize("kind", ["orbit", "llff"])
def test_projection_planes(rng, kind):
    target_cam, _, src_cams, _, depth_range = _scene(rng, kind)
    pts = rng.uniform(-1.5, 1.5, (200, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    jx, jy, jf = jproj.project_points_planes(jnp.asarray(pts),
                                             jnp.asarray(src_cams))
    tx, ty, tf = tproj.project_points_planes(_t(pts), _t(src_cams))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    ja = jproj.compute_angle_planes(jnp.asarray(pts), jnp.asarray(target_cam),
                                    jnp.asarray(src_cams))
    ta = tproj.compute_angle_planes(_t(pts), _t(target_cam), _t(src_cams))
    for a, b in zip(ja, ta):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    jm = jproj.inbound_mask_planes(jx, jy, H, W)
    tm = tproj.inbound_mask_planes(tx, ty, H, W)
    # coordinates agree to ~1e-5 px; a point that close to the border may
    # flip, none does on this draw
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_grid_sample_oracle_matches_jax_gather(rng):
    """F.grid_sample (align_corners, zeros padding) == the JAX per-tap
    gather, including taps past the border (partial corners) and far
    outside (all zero). f32 bilinear blends: 1e-6 absolute."""
    images = rng.rand(3, 11, 17, 5).astype(np.float32)
    gx = rng.uniform(-1.3, 1.3, (3, 300)).astype(np.float32)
    gy = rng.uniform(-1.3, 1.3, (3, 300)).astype(np.float32)
    gx[:, :4] = [-1.0, 1.0, -1.05, 1.02]  # exact edges and just beyond
    ref = j_gather(jnp.asarray(images), jnp.asarray(gx), jnp.asarray(gy))
    out = tproj.gather_bilinear_planes(_t(images), _t(gx), _t(gy))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).reshape(3, 300, 5),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("inv_uniform", [False, True])
def test_sampling_matches(rng, inv_uniform):
    target_cam, _, _, _, depth_range = _scene(rng)
    (jo, jd), _ = _rays(target_cam)
    n_s, n_i = 16, 12
    jp, jz = jsamp.sample_along_camera_ray(
        jnp.asarray(jo), jnp.asarray(jd), jnp.asarray(depth_range), n_s,
        inv_uniform=inv_uniform, det=True)
    tp, tz = tsamp.sample_along_camera_ray(_t(jo), _t(jd), _t(depth_range),
                                           n_s, inv_uniform=inv_uniform)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    # importance sampling from the same weights. The two cumsums round in
    # different orders, so a quantile that lands within an ulp of a cdf
    # entry can take the neighbouring bin: hold 99.9% of the depths to 1e-5
    # relative and every depth to one coarse bin width
    weights = rng.rand(jz.shape[0], n_s).astype(np.float32)
    jf = np.asarray(jsamp.sample_fine_zvals(jz, jnp.asarray(weights), n_i,
                                            inv_uniform=inv_uniform, det=True))
    tf = tsamp.sample_fine_zvals(tz, _t(weights), n_i,
                                 inv_uniform=inv_uniform).numpy()
    close = np.isclose(tf, jf, rtol=1e-5, atol=0)
    assert close.mean() > 0.999, close.mean()
    bin_w = float(np.diff(np.asarray(jz), axis=-1).max())
    assert np.abs(tf - jf).max() <= bin_w


def test_raw2outputs_matches(rng):
    raw = rng.randn(50, 20, 4).astype(np.float32)
    raw[..., 3] = np.abs(raw[..., 3])
    z = np.sort(rng.uniform(2.0, 6.0, (50, 20)), -1).astype(np.float32)
    pm = rng.rand(50, 20) > 0.4
    for white in (False, True):
        j = jcomp.raw2outputs(jnp.asarray(raw), jnp.asarray(z),
                              jnp.asarray(pm), white_bkgd=white)
        t = tcomp.raw2outputs(_t(raw), _t(z), _t(pm), white_bkgd=white)
        for k in ("rgb", "depth", "weights", "alpha"):
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(t["mask"].numpy(), np.asarray(j["mask"]))


def test_psnr_ssim_match(rng):
    """TF-protocol PSNR/SSIM (VALID 11x11 Gaussian) on the same images:
    f32 on both sides, 1e-4 dB and 1e-5 SSIM."""
    gt = rng.rand(30, 40, 3).astype(np.float32)
    pred = np.clip(gt + 0.1 * rng.randn(30, 40, 3), 0, 1).astype(np.float32)
    assert abs(float(tmetrics.psnr(_t(pred), _t(gt)))
               - float(jmetrics.psnr(jnp.asarray(pred), jnp.asarray(gt)))) < 1e-4
    assert abs(float(tmetrics.ssim(_t(pred), _t(gt)))
               - float(jmetrics.ssim(jnp.asarray(pred), jnp.asarray(gt)))) < 1e-5
