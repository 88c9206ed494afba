"""Operation and byte counts from shapes, and the card's published peaks.

Counts are of the mathematics, not of an implementation: a multiply-add is
two operations, each input byte is read once and each output byte written
once. A route that computes the same function another way (an FFT
convolution, a kernel that splits an f32 product into three TF32 ones)
changes no count.
"""

# NVIDIA H100 SXM data sheet, dense: the TF32 tensor-core rate (every
# f32 product of the program could run on it) and the HBM3 bandwidth
PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12


def least_seconds(flops, n_bytes):
    """The least time the card could take: the larger of the operations at
    the peak rate and the bytes at the memory rate."""
    return max(flops / PEAK_FLOPS, n_bytes / PEAK_BYTES)
