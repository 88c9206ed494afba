"""What the span readers in ``metrics/`` share: the port's span records of
the traced window (``nerfool_tpu_torch.utils.profiling``), taken once per
window and kept on the ``Traced`` the readers are handed.

Spans record only while a profiler records, so the records cover the traced
window alone. A program without spans (an older checkout) gives None, and so
does every reader; so does a window with no device activity.
"""
from __future__ import annotations


def records(traced):
    """The window's span records, or None where the program has none or
    the window ran nothing on a device (as every reader, silent off the
    card)."""
    if "spans" not in vars(traced):
        try:
            from nerfool_tpu_torch.utils.profiling import take_spans
        except ImportError:
            traced.spans = None
        else:
            taken = take_spans()
            traced.spans = taken if traced.trace.device else None
    return traced.spans


def named(traced, *names):
    """The window's records whose name is one of ``names`` (a name ending
    in ``.`` takes every name that starts with it), or None where there is
    none."""
    recs = records(traced) or ()
    out = [r for r in recs if any(
        r.name.startswith(n) if n.endswith(".") else r.name == n
        for n in names)]
    return out or None


def stream_ms_per_unit(traced, *names):
    """Stream ms of the spans ``names`` per unit of work, or None."""
    recs = named(traced, *names)
    if recs is None or any(r.stream_ms is None for r in recs):
        return None
    return sum(r.stream_ms for r in recs) / traced.units
