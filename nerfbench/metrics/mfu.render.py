"""The frame's model operations (the feature net on its sources, the
aggregator over its rays) per second of the traced window, as a share of
the card's TF32 peak."""
from nerfbench.readers import aggregator_flops, feature_flops, mfu_pct


def read(traced):
    flops = (feature_flops(traced)
             + aggregator_flops(traced, traced.rays_per_unit, backward=False))
    return mfu_pct(traced, flops)
