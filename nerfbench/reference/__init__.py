"""Plain PyTorch references of what the benchmark runs: the published
networks and renderer, frozen here, importing nothing of the program."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32):
    """f32 products and convolutions in full f32 (``tf32`` False) or on the
    TF32 tensor cores (True) inside the block; the flags as they were after
    it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
