"""Host ms per attack iteration inside the port's ``attack.step`` span."""
from nerfbench.spans import named


def read(traced):
    recs = named(traced, "attack.step")
    return None if recs is None else sum(
        r.host_ms for r in recs) / traced.units
