"""Host ms per chunk of the frame's render loop (the ``render.chunk``
spans)."""
from nerfbench.spans import named


def read(traced):
    recs = named(traced, "render.chunk")
    return None if recs is None else sum(r.host_ms for r in recs) / len(recs)
