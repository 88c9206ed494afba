"""Device ms per frame under the convolution operators (the feature net
on the frame's sources)."""
from nerfbench.readers import device_ms_per_unit, under_op


def read(traced):
    return device_ms_per_unit(traced, under_op("convolution"))
