"""Stream ms per attack iteration of the ``attack.features`` span: the
feature net on the perturbed sources, forward."""
from nerfbench.spans import stream_ms_per_unit


def read(traced):
    return stream_ms_per_unit(traced, "attack.features")
