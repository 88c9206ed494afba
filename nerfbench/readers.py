"""What the per-layer metrics in ``metrics/`` share: device time under
operators or kernels per unit of work, the idle share, and the model's
operations per unit counted from the cell's shapes."""
from __future__ import annotations

from nerfbench.counts import PEAK_FLOPS, gnt, ibrnet, resunet


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
    out = int(f.get("coarse_feat_dim", 32))
    if not (f["backbone"] == "gnt" and str(f.get("single_net")) == "True"):
        out += int(f.get("fine_feat_dim", 32))
    return resunet.forward_flops(traced.n_views, *traced.feature_hw, out)


def aggregator_flops(traced, rays, backward):
    """The aggregator's forward (and with ``backward`` its gradient to the
    inputs) over ``rays`` rays."""
    f = traced.flags
    v, s = traced.n_views, int(f["N_samples"])
    if f["backbone"] == "gnt":
        d, depth = int(f["netwidth"]), int(f["trans_depth"])
        per = gnt.per_ray(v, s, d, depth)
        if backward:
            per += gnt.backward_per_ray(v, s, d, depth)
    else:
        i = int(f.get("N_importance", 64))
        per = ibrnet.per_ray(v, s, i)
        if backward:
            per += ibrnet.backward_per_ray(v, s, i)
    return rays * per


def mfu_pct(traced, flops_per_unit):
    """None where the trace holds no device activity."""
    if traced.trace.busy_s() <= 0:
        return None
    seconds_per_unit = traced.trace.window_s / traced.units
    return 100.0 * flops_per_unit / seconds_per_unit / PEAK_FLOPS
