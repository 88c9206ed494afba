"""Stream ms per frame of the ``render.gather.*`` spans: the taps of every
level (per tap: the projection, ``F.grid_sample`` and the rgb-feature
concatenation)."""
from nerfbench.spans import stream_ms_per_unit


def read(traced):
    return stream_ms_per_unit(traced, "render.gather.")
