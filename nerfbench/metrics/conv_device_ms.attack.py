"""Device ms per attack iteration under the convolution operators (the
feature net's forward and its backward to the input)."""
from nerfbench.readers import device_ms_per_unit, under_op


def read(traced):
    return device_ms_per_unit(traced, under_op("convolution"))
