"""K3's share of its roofline in an attack iteration: the least time of
its forward and backward launches (one each per block) over the device
time of its kernels."""
from nerfbench.counts.gnt import k3_least_seconds
from nerfbench.readers import device_ms_per_unit, kernel_named


def read(traced):
    ms = device_ms_per_unit(traced, kernel_named(
        "ra_fwd_kernel", "ra_bwd_kernel", "ra_pack_kernel"))
    if ms is None:
        return None
    f = traced.flags
    least = k3_least_seconds(traced.rays_per_unit, int(f["N_samples"]),
                             int(f["trans_depth"]), backward=True,
                             d=int(f["netwidth"]))
    return 100.0 * 1e3 * least / ms
