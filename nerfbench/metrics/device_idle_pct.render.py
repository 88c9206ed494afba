"""Share of the traced render window in which no device activity ran."""
from nerfbench.readers import idle_pct


def read(traced):
    return idle_pct(traced)
