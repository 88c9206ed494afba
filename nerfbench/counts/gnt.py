"""GNT's aggregator and its kernels K3 (ray attention) and K4 (view
attention): operations and bytes, counted from the published widths."""
from __future__ import annotations

from nerfbench.counts import least_seconds


def per_sample(n_views, n_samples, d=64, depth=8, feat=32, pe=63):
    """Forward operations per sample: the entry MLP on every view, then per
    block the view transformer (q, k | v, the position and attention MLPs
    on every view, the output product, the feed-forward) and the ray
    transformer (q | k | v, scores and weighted sum, output product, the
    feed-forward), and the embedding MLP before every even block."""
    h = d // 8
    view = (2 * d * d + n_views * 2 * d * 2 * d
            + n_views * 2 * (4 * h + h * d) + n_views * 2 * (d * h + h * d)
            + 2 * d * d + 2 * 2 * d * 4 * d)
    ray = 2 * d * 3 * d + 4 * n_samples * d + 2 * d * d + 2 * 2 * d * 4 * d
    q_fc = 2 * (d + 2 * pe) * d + 2 * d * d
    entry = n_views * 2 * ((feat + 3) * d + d * d)
    return entry + depth * (view + ray) + -(-depth // 2) * q_fc


def per_ray(n_views, n_samples, d=64, depth=8, feat=32):
    return n_samples * per_sample(n_views, n_samples, d, depth, feat)


def backward_per_ray(n_views, n_samples, d=64, depth=8, feat=32):
    """Operations of the gradient to the inputs (weights frozen): one
    product per linear layer, two per attention product."""
    return (per_ray(n_views, n_samples, d, depth, feat)
            + depth * n_samples * 4 * n_samples * d)


def k3_forward(rays, samples, d=64, heads=4):
    """(operations, bytes) of one ray-attention forward: q | k | v, scores,
    the weighted sum and the output product; the softmax (max, subtract,
    exponent, sum) per score; x in, out and the head-mean first row out,
    the weights once."""
    rs = rays * samples
    ops = rs * (2 * d * 3 * d + 4 * samples * d + 2 * d * d) \
        + rays * heads * samples * samples * 4
    n_bytes = 4 * (2 * rs * d + rs) + 4 * (d * 3 * d + d * d + d)
    return ops, n_bytes


def k3_backward(rays, samples, d=64, heads=4):
    """(operations, bytes) of one ray-attention backward to the input,
    weights frozen: q | k | v and the output cotangent's projection, scores
    and weighted sum again, dp, dq, dk, dv and dx; a softmax and its
    derivative per score; x, the two cotangents in, dx out, the weights
    once."""
    rs = rays * samples
    ops = rs * (14 * d * d + 12 * samples * d) \
        + rays * heads * samples * samples * 7
    n_bytes = 4 * (3 * rs * d + rs) + 4 * (d * 3 * d + d * d)
    return ops, n_bytes


def k4(n_views, rows, d=64):
    """(operations, bytes) of one view attention over ``rows`` samples:
    the query, key | value and output products, the position and attention
    MLPs per view; qln, k, pos and mask in, out written, the weights
    once."""
    h = d // 8
    ops = (rows * (n_views * 2 * d * 2 * d + 2 * 2 * d * d)
           + rows * n_views * (2 * (4 * h + h * d) + 2 * (d * h + h * d)))
    w_bytes = 4 * (4 * d * d + 4 * h + 3 * h * d + 2 * h + 3 * d)
    n_bytes = 4 * (n_views * rows * (d + 4 + 1) + 2 * rows * d) + w_bytes
    return ops, n_bytes


def k3_least_seconds(rays, samples, depth, backward, d=64, heads=4):
    """Least seconds of one forward (and backward) per block."""
    total = least_seconds(*k3_forward(rays, samples, d, heads))
    if backward:
        total += least_seconds(*k3_backward(rays, samples, d, heads))
    return depth * total


def k4_least_seconds(n_views, chunks, samples, depth, d=64):
    """Least seconds of a frame's view attentions: ``depth`` per chunk of
    rays (``chunks`` the ray counts)."""
    return depth * sum(least_seconds(*k4(n_views, r * samples, d))
                       for r in chunks)
