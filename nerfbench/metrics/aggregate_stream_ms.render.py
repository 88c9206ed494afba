"""Stream ms per frame of the ``render.aggregate.*`` spans: the aggregator
of every level."""
from nerfbench.spans import stream_ms_per_unit


def read(traced):
    return stream_ms_per_unit(traced, "render.aggregate.")
