"""The ResUNet feature net's convolutions, counted from the input size."""
from __future__ import annotations


def _out(n, k, stride, pad):
    return (n + 2 * pad - k) // stride + 1


def conv_layers(h, w, out_ch):
    """(c_in, c_out, k, h_out, w_out) of every convolution, in order."""
    layers = []
    h1, w1 = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    layers.append((3, 64, 7, h1, w1))
    hh, ww, cin = h1, w1, 64
    sizes = []
    for planes, blocks in ((64, 3), (128, 4), (256, 6)):
        hh, ww = _out(hh, 3, 2, 1), _out(ww, 3, 2, 1)
        layers += [(cin, planes, 3, hh, ww), (planes, planes, 3, hh, ww),
                   (cin, planes, 1, hh, ww)]
        layers += [(planes, planes, 3, hh, ww)] * (2 * (blocks - 1))
        sizes.append((hh, ww))
        cin = planes
    # decoder: x2 upsampling of the deepest map, the skips padded to it
    uh, uw = 2 * hh, 2 * ww
    layers += [(256, 128, 3, uh, uw), (256, 128, 3, uh, uw)]
    uh, uw = 2 * uh, 2 * uw
    layers += [(128, 64, 3, uh, uw), (128, out_ch, 3, uh, uw),
               (out_ch, out_ch, 1, uh, uw)]
    return layers


def forward_flops(n_views, h, w, out_ch):
    """Operations of the forward pass over ``n_views`` images of h x w."""
    return n_views * sum(2 * ci * co * k * k * ho * wo
                         for ci, co, k, ho, wo in conv_layers(h, w, out_ch))
