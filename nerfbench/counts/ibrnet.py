"""IBRNet's aggregator: operations of its matrix products and attention
per sample, counted from its published widths."""
from __future__ import annotations


def _mlp(din, widths):
    ops = 0
    for f in widths:
        ops += 2 * din * f
        din = f
    return ops


def per_view_sample(feat=32):
    """The MLPs run on every (view, sample): direction, base, visibility
    (two), colour blend."""
    c = feat + 3
    return (_mlp(4, [16, c]) + _mlp(3 * c, [64, 32]) + _mlp(32, [32, 33])
            + _mlp(32, [32, 1]) + _mlp(37, [16, 8, 1]))


def per_sample(n_views, n_samples, feat=32, d=16):
    """Forward operations per sample of a ray with ``n_samples`` samples:
    the per-view MLPs, the geometry MLP, the ray attention (q, k, v and
    output projections, scores and the weighted sum) and the density
    head."""
    attn = 4 * 2 * d * d + 2 * 2 * n_samples * d
    return (n_views * per_view_sample(feat) + _mlp(65, [64, 16]) + attn
            + _mlp(16, [16, 1]))


def per_ray(n_views, n_samples, n_importance, feat=32):
    """Forward operations per ray, both levels."""
    ops = n_samples * per_sample(n_views, n_samples, feat)
    if n_importance:
        s = n_samples + n_importance
        ops += s * per_sample(n_views, s, feat)
    return ops


def backward_per_ray(n_views, n_samples, n_importance, feat=32, d=16):
    """Operations of the gradient to the inputs (weights frozen): one
    product per linear layer, two per attention product."""
    ops = per_ray(n_views, n_samples, n_importance, feat)
    for s in (n_samples, n_samples + n_importance if n_importance else 0):
        ops += s * 2 * 2 * s * d  # the attention core's second product
    return ops
