"""Stream ms per frame of the ``render.fine_sampler`` spans: the fine
depths drawn from the coarse weights, and the fine points."""
from nerfbench.spans import stream_ms_per_unit


def read(traced):
    return stream_ms_per_unit(traced, "render.fine_sampler")
