"""The reference against the port at a tiny size on the CPU, module by
module, with the benchmark's seeded weights: the feature net, both
aggregators and the ray renderer."""
import pytest
import torch

from nerfbench import program
from nerfbench.reference import render as ref_render
from nerfbench.scene import Rig
from nerfbench.tests.tiny import SCENE, tiny_cell

torch.set_num_threads(2)


def built(name, seed=11):
    cell = tiny_cell(name)
    sd = program.weights(cell.config, cell.traffic, seed, "cpu")
    ev = program.build_evaluator(cell.config, cell.traffic, sd, seed, "cpu")
    feature_net, model = program.reference_model(cell.config, cell.traffic,
                                                 sd)
    return cell, ev, feature_net, model


@pytest.mark.parametrize("name", ["ibrnet_llff_attack", "gnt_full_attack"])
def test_feature_net_matches_port(name):
    _, ev, feature_net, _ = built(name)
    x = torch.rand(3, 48, 64, 3, generator=torch.Generator().manual_seed(0))
    for a, b in zip(ev.bundle.extract_features(x), feature_net(x)):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", ["ibrnet_llff_attack", "gnt_full_attack"])
def test_ray_render_matches_port(name):
    from nerfool_tpu_torch.render.render_rays import render_rays
    from nerfool_tpu_torch.utils.cameras import get_rays_at

    cell, ev, feature_net, model = built(name)
    rig = Rig(SCENE, 5, "cpu")
    view = rig.views[1]
    t = lambda x: torch.as_tensor(x)
    cam, src, cams = t(view["camera"]), t(view["src_rgbs"]), t(
        view["src_cameras"])
    sel = torch.arange(0, 48 * 64, 7)
    with torch.no_grad():
        feats = ev.bundle.extract_features(src)
        ro, rd = get_rays_at(sel, 64, cam[2:18].reshape(4, 4),
                             cam[18:34].reshape(4, 4))
        batch = {"ray_o": ro, "ray_d": rd, "camera": cam[None],
                 "depth_range": t(view["depth_range"]).reshape(1, 2)}
        port = render_rays(ev.bundle.nets, batch, feats,
                           ev._grad_render_cfg(), src, cams)
        ro2, rd2 = ref_render.rays_at(sel, cam)
        given = (None if port["outputs_fine"] is None
                 else port["outputs_coarse"]["weights"])
        ref = model["backbone"].render_rays(
            model, ro2, rd2, cam, t(view["depth_range"]), feature_net(src),
            src, cams, given=None if given is None else {
                "coarse": {"weights": given}})
    torch.testing.assert_close(ro, ro2)
    torch.testing.assert_close(rd, rd2)
    for level, ours in (("outputs_coarse", "coarse"), ("outputs_fine", "fine")):
        if port[level] is None:
            assert ref[ours] is None
            continue
        for q in ("rgb", "depth"):
            torch.testing.assert_close(port[level][q], ref[ours][q],
                                       rtol=1e-4, atol=1e-4)
    if given is not None:  # the fine level drawn from the port's weights
        for q in ("rgb", "depth"):
            torch.testing.assert_close(port["outputs_fine"][q],
                                       ref["fine_given_coarse"][q],
                                       rtol=1e-4, atol=1e-4)
