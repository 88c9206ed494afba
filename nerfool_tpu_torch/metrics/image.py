"""PSNR and SSIM in the reference's two protocols (port of
``nerfool_tpu/metrics/image.py``). IBRNet results use TensorFlow's:
``psnr`` is ``tf.image.psnr`` and ``ssim`` is ``tf.image.ssim`` with an 11x11
Gaussian (sigma 1.5), k1=0.01, k2=0.03 and VALID padding. GNT results use
``img2psnr`` (the mse carries a 1e-6 floor) and ``ssim_windowed``, the same
Gaussian window with SAME (zero) padding.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


TINY = 1e-6


def img2psnr(pred, gt):
    """-10 log10(mse + 1e-6) over the full image."""
    return -10.0 * torch.log10(torch.mean((pred - gt) ** 2) + TINY)


def psnr(pred, gt, max_val=1.0):
    """10 log10(max^2 / mse) over the full image."""
    mse = torch.mean((pred - gt) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / mse)


def _gaussian_kernel(size=11, sigma=1.5, dtype=torch.float32, device=None):
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    return torch.as_tensor(np.outer(g, g), dtype=dtype, device=device)


def _filter2d(img, kernel, padding):
    """Depthwise 2D correlation, VALID (0) or SAME (k // 2) zero padding.
    img [H, W, C], kernel [k, k]."""
    x = img.permute(2, 0, 1)[:, None]  # [C, 1, H, W]
    out = F.conv2d(x, kernel[None, None], padding=padding)
    return out[:, 0].permute(1, 2, 0)


def _ssim(pred, gt, max_val, kernel, padding):
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_x = _filter2d(pred, kernel, padding)
    mu_y = _filter2d(gt, kernel, padding)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_x = _filter2d(pred * pred, kernel, padding) - mu_xx
    sigma_y = _filter2d(gt * gt, kernel, padding) - mu_yy
    sigma_xy = _filter2d(pred * gt, kernel, padding) - mu_xy
    lum = (2 * mu_xy + c1) / (mu_xx + mu_yy + c1)
    cs = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    return torch.mean(lum * cs)


def ssim(pred, gt, max_val=1.0):
    """tf.image.ssim: VALID padding. :param pred, gt: [H, W, C]"""
    kernel = _gaussian_kernel(11, 1.5, pred.dtype, pred.device)
    return _ssim(pred, gt, max_val, kernel, 0)


def ssim_windowed(pred, gt):
    """GNT's SSIM: SAME padding, mean over the map. :param pred, gt:
    [H, W, C]"""
    kernel = _gaussian_kernel(11, 1.5, pred.dtype, pred.device)
    return _ssim(pred, gt, 1.0, kernel, 5)
