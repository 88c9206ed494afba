"""K4's share of its roofline in a frame: the least time of its launches
(one per block per chunk) over the device time of its kernel."""
from nerfbench.counts.gnt import k4_least_seconds
from nerfbench.readers import device_ms_per_unit, kernel_named


def read(traced):
    ms = device_ms_per_unit(traced, kernel_named("va_kernel"))
    if ms is None:
        return None
    f = traced.flags
    least = k4_least_seconds(traced.n_views, traced.chunks,
                             int(f["N_samples"]), int(f["trans_depth"]),
                             d=int(f["netwidth"]))
    return 100.0 * 1e3 * least / ms
