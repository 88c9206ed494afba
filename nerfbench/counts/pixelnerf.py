"""pixelNeRF: the encoder's convolutions and the ``ResnetFC``'s products,
counted from the shapes; the ``ResnetFC``'s bytes for its roofline."""
from __future__ import annotations

from nerfbench.counts import least_seconds


def _out(n, k, stride, pad):
    return (n + 2 * pad - k) // stride + 1


def encoder_layers(h, w):
    """(c_in, c_out, k, h_out, w_out) of the 29 convolutions of ResNet-34
    to ``layer3`` over an h x w image: the 7x7/2 stem, the 3x3/2 max pool,
    then 3, 4 and 6 blocks of 64, 128 and 256 channels (stride 2 and a 1x1
    downsample at the first block of the last two)."""
    hh, ww = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    layers = [(3, 64, 7, hh, ww)]
    hh, ww = _out(hh, 3, 2, 1), _out(ww, 3, 2, 1)
    cin = 64
    for planes, blocks, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2)):
        hh, ww = _out(hh, 3, stride, 1), _out(ww, 3, stride, 1)
        layers += [(cin, planes, 3, hh, ww), (planes, planes, 3, hh, ww)]
        if stride != 1:
            layers.append((cin, planes, 1, hh, ww))
        layers += [(planes, planes, 3, hh, ww)] * (2 * (blocks - 1))
        cin = planes
    return layers


def encoder_flops(n_views, h, w):
    """Operations of the encoder's forward over ``n_views`` images (its
    input gradient has as many)."""
    return n_views * sum(2 * ci * co * k * k * ho * wo
                         for ci, co, k, ho, wo in encoder_layers(h, w))


def mlp_flops(n_views, points, d_in=42, n_blocks=5, d_hidden=512,
              combine_layer=3, d_latent=512, d_out=4):
    """Operations of ``ResnetFC``'s forward over ``points`` samples seen
    by ``n_views`` views: ``lin_in``, ``lin_z`` and the first blocks per
    view, the other blocks and ``lin_out`` per sample."""
    per_view = d_in * d_hidden + combine_layer * (
        d_latent * d_hidden + 2 * d_hidden * d_hidden)
    per_point = (n_blocks - combine_layer) * 2 * d_hidden * d_hidden + \
        d_hidden * d_out
    return 2 * points * (n_views * per_view + per_point)


def mlp_bytes(n_views, points, d_in=42, n_blocks=5, d_hidden=512,
              combine_layer=3, d_latent=512, d_out=4):
    """Bytes of ``ResnetFC``'s forward in float32: its inputs (the latent
    taps and the encoded inputs of every view) and weights read once, its
    output written once."""
    params = (d_in + 1) * d_hidden + combine_layer * (d_latent + 1) * \
        d_hidden + n_blocks * 2 * (d_hidden + 1) * d_hidden + \
        (d_hidden + 1) * d_out
    return 4 * (n_views * points * (d_latent + d_in) + points * d_out
                + params)


def mlp_least_seconds(n_views, points, **widths):
    return least_seconds(mlp_flops(n_views, points, **widths),
                         mlp_bytes(n_views, points, **widths))
