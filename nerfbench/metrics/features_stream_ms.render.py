"""Stream ms per frame of the ``eval.features`` span: the feature net on
the frame's sources."""
from nerfbench.spans import stream_ms_per_unit


def read(traced):
    return stream_ms_per_unit(traced, "eval.features")
