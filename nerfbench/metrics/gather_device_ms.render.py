"""Device ms per frame under the grid-sampler operators (``grid_sampler_2d``,
``cudnn_grid_sampler``): the per-tap bilinear
gather of colours and features."""
from nerfbench.readers import device_ms_per_unit, under_op


def read(traced):
    return device_ms_per_unit(traced, under_op("grid_sampler"))
