"""What the per-layer metrics in ``metrics/`` share: device time under
operators or kernels per unit of work, the idle share, and the model's
operations per unit counted from the cell's shapes."""
from __future__ import annotations

from nerfbench import backbones
from nerfbench.counts import PEAK_FLOPS


def device_ms_per_unit(traced, match):
    """Device ms per unit of the activities ``match(name, operator)``
    selects, or None where the trace holds none."""
    s = traced.trace.device_s(match)
    return 1e3 * s / traced.units if s > 0 else None


def under_op(part):
    """Activities launched under a host operator whose name holds
    ``part``."""
    return lambda name, op: op is not None and part in op


def kernel_named(*parts):
    return lambda name, op: any(p in name for p in parts)


def idle_pct(traced):
    busy = traced.trace.busy_s()
    if busy <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - busy / traced.trace.window_s)


def feature_flops(traced):
    """The feature net's forward over the sources."""
    f = traced.flags
    return backbones.of(f).feature_flops(f, traced.n_views,
                                         *traced.feature_hw)


def aggregator_flops(traced, rays, backward):
    """The aggregator's forward (and with ``backward`` its gradient to the
    inputs) over ``rays`` rays."""
    f = traced.flags
    return backbones.of(f).aggregator_flops(f, traced.n_views, rays,
                                            backward)


def mfu_pct(traced, flops_per_unit):
    """None where the trace holds no device activity."""
    if traced.trace.busy_s() <= 0:
        return None
    seconds_per_unit = traced.trace.window_s / traced.units
    return 100.0 * flops_per_unit / seconds_per_unit / PEAK_FLOPS
