"""Stream ms per attack iteration of the ``pixelnerf.latent`` span: the
encoder's levels upsampled to the first one's size and concatenated into
the 512-channel latent map, forward."""
from nerfbench.spans import stream_ms_per_unit


def read(traced):
    return stream_ms_per_unit(traced, "pixelnerf.latent")
