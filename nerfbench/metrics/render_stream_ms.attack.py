"""Stream ms per attack iteration of the ``attack.render`` spans: the ray
renders of the losses, forward."""
from nerfbench.spans import stream_ms_per_unit


def read(traced):
    return stream_ms_per_unit(traced, "attack.render")
