"""The operation and byte counts of ``nerfbench/counts`` against shapes
worked by hand and against PyTorch's own count of the reference modules'
products."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from nerfbench.counts import gnt, ibrnet, least_seconds, resunet
from nerfbench.reference.gnt import GNT
from nerfbench.reference.ibrnet import IBRNet
from nerfbench.reference.resunet import ResUNet

torch.set_num_threads(2)


def test_resunet_at_llff_size_is_60_9_gmac_per_view():
    # 756x1008: stem 378x504, stages 189x252, 95x126, 48x63, decoder
    # 96x126 and 192x252 (by hand: 60.936 GMAC)
    layers = resunet.conv_layers(756, 1008, 64)
    assert layers[0] == (3, 64, 7, 378, 504)
    assert layers[1] == (64, 64, 3, 189, 252)
    assert layers[-1] == (64, 64, 1, 192, 252)
    assert len(layers) == 1 + 3 * 3 + 2 * (2 + 3 + 5) + 5
    assert resunet.forward_flops(1, 756, 1008, 64) == 2 * 60_935_906_304


@pytest.mark.parametrize("h, w, single", [(48, 64, False), (40, 56, True)])
def test_resunet_count_matches_pytorch_count(h, w, single):
    net = ResUNet(32, 32, single_net=single)
    with FlopCounterMode(display=False) as fc:
        net(torch.rand(2, h, w, 3))
    assert resunet.forward_flops(2, h, w, 32 if single else 64) == \
        fc.get_total_flops()


def test_ibrnet_per_view_sample_by_hand():
    # 4-16-35, 105-64-32, 32-32-33, 32-32-1, 37-16-8-1, two flops a MAC
    assert ibrnet.per_view_sample() == 2 * (
        4 * 16 + 16 * 35 + 105 * 64 + 64 * 32 + 32 * 32 + 32 * 33
        + 32 * 32 + 32 + 37 * 16 + 16 * 8 + 8)


def test_ibrnet_count_matches_pytorch_count():
    v, r, s = 3, 5, 7
    net = IBRNet(32)
    with FlopCounterMode(display=False) as fc:
        net(torch.rand(v, r, s, 35), torch.rand(v, r, s, 4),
            torch.ones(v, r, s, 1))
    assert r * s * ibrnet.per_sample(v, s) == fc.get_total_flops()


def test_gnt_count_matches_pytorch_count():
    v, r, s, depth = 3, 4, 6, 2
    net = GNT(32, 64, depth)
    with FlopCounterMode(display=False) as fc:
        net(torch.rand(v, r, s, 35), torch.rand(v, r, s, 4),
            torch.ones(v, r, s, 1), torch.rand(r, s, 3), torch.rand(r, 3))
    # PyTorch also counts the head's rgb product (2 x 64 x 3 a ray)
    assert gnt.per_ray(v, s, 64, depth) * r + r * 2 * 64 * 3 == \
        fc.get_total_flops()


def test_kernel_counts_by_hand():
    rs = 2 * 3
    ops, n_bytes = gnt.k3_forward(2, 3, d=8, heads=2)
    assert ops == rs * (2 * 8 * 24 + 4 * 3 * 8 + 2 * 64) + 2 * 2 * 9 * 4
    assert n_bytes == 4 * (2 * rs * 8 + rs) + 4 * (8 * 24 + 64 + 8)
    ops, n_bytes = gnt.k3_backward(2, 3, d=8, heads=2)
    assert ops == rs * (14 * 64 + 12 * 3 * 8) + 2 * 2 * 9 * 7
    ops, n_bytes = gnt.k4(2, 5, d=16)
    assert ops == 5 * (2 * 2 * 16 * 32 + 2 * 2 * 256) + 5 * 2 * (
        2 * (4 * 2 + 2 * 16) + 2 * (16 * 2 + 2 * 16))
    assert least_seconds(495e12, 0) == 1.0
    assert least_seconds(0, 3.35e12) == 1.0
