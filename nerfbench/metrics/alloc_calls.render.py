"""The caching allocator's device allocations and frees
(``num_device_alloc + num_device_free``) across ``eval.render_view``, per
frame: zero where every block a frame takes is cached."""
from nerfbench.spans import named

KEYS = ("num_device_alloc", "num_device_free")


def read(traced):
    recs = named(traced, "eval.render_view")
    if recs is None or not all(r.counters and all(
            k in r.counters for k in KEYS) for r in recs):
        return None
    return sum(r.counters[k] for r in recs for k in KEYS) / traced.units
