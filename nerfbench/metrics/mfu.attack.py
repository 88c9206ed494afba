"""The attack iteration's model operations (the feature net forward and
its gradient to the input, the aggregator forward and its gradient to its
inputs, over the iteration's rays) per second of the traced window, as a
share of the card's TF32 peak."""
from nerfbench.readers import aggregator_flops, feature_flops, mfu_pct


def read(traced):
    flops = (2 * feature_flops(traced)
             + aggregator_flops(traced, traced.rays_per_unit, backward=True))
    return mfu_pct(traced, flops)
