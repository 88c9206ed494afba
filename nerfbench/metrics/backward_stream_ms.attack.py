"""Stream ms per attack iteration of the ``attack.backward`` span: the
gradient to the perturbation through the renderer and the feature net."""
from nerfbench.spans import stream_ms_per_unit


def read(traced):
    return stream_ms_per_unit(traced, "attack.backward")
