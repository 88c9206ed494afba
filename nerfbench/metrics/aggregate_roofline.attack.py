"""The aggregator against its roofline in an attack iteration: the least
time of its forward over the iteration's samples (both levels, every
source view), as the backbone's ``aggregator_least_seconds`` gives it, over
the stream ms of the ``render.aggregate.*`` spans inside ``attack.render``,
in %. None where the backbone gives no such time (pixelNeRF's ResnetFC
does: ``backbones/pixelnerf.py``, ``counts/pixelnerf.py``)."""
from nerfbench import backbones
from nerfbench.spans import named, records


def _inside(rec, ancestor, by_id):
    while rec.parent is not None:
        rec = by_id.get(rec.parent)
        if rec is None:
            return False
        if rec.name == ancestor:
            return True
    return False


def read(traced):
    least_seconds = getattr(backbones.of(traced.flags),
                            "aggregator_least_seconds", None)
    if least_seconds is None:
        return None
    recs = named(traced, "render.aggregate.")
    if recs is None or any(r.stream_ms is None for r in recs):
        return None
    by_id = {r.id: r for r in records(traced)}
    ms = sum(r.stream_ms for r in recs
             if _inside(r, "attack.render", by_id)) / traced.units
    if ms <= 0:
        return None
    least = least_seconds(traced.flags, traced.n_views,
                          traced.rays_per_unit)
    return 100.0 * 1e3 * least / ms
