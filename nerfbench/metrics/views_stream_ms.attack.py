"""Stream ms per attack iteration of the ``pixelnerf.views`` spans: the
per-view blocks of pixelNeRF's MLP (``lin_in``, and each block before the
views' mean with its ``lin_z``), forward, both levels."""
from nerfbench.spans import stream_ms_per_unit


def read(traced):
    return stream_ms_per_unit(traced, "pixelnerf.views")
