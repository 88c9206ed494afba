"""Camera codec and ray generation (port of ``nerfool_tpu/utils/cameras.py``).

A camera is a 34-vector ``[H, W, K.flatten()(16), c2w.flatten()(16)]`` with a
4x4 intrinsics matrix and a 4x4 OpenCV camera-to-world matrix.
"""
from __future__ import annotations

import torch


def parse_camera(cameras):
    """Split camera vectors [..., 34] -> (W, H, intrinsics [...,4,4], c2w [...,4,4])."""
    h = cameras[..., 0]
    w = cameras[..., 1]
    intrinsics = cameras[..., 2:18].reshape(cameras.shape[:-1] + (4, 4))
    c2w = cameras[..., 18:34].reshape(cameras.shape[:-1] + (4, 4))
    return w, h, intrinsics, c2w


def get_rays(h, w, intrinsics, c2w, render_stride=1):
    """Per-pixel rays for one camera, pixel (u, v) at its integer coordinate
    (no half-pixel shift), row-major order (v outer, u inner).

    :param h, w: ints (image size)
    :param intrinsics, c2w: [4, 4] float32 tensors
    :return: (rays_o [N, 3], rays_d [N, 3]), N = ceil(h/stride)*ceil(w/stride)
    """
    dev = c2w.device
    u = torch.arange(0, w, render_stride, dtype=torch.float32, device=dev)
    v = torch.arange(0, h, render_stride, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")  # [H', W'] each
    pixels = torch.stack([uu.reshape(-1), vv.reshape(-1),
                          torch.ones_like(uu.reshape(-1))], dim=0)
    k_inv = torch.linalg.inv(intrinsics[:3, :3])
    rays_d = (c2w[:3, :3] @ (k_inv @ pixels)).T.contiguous()  # [N, 3]
    rays_o = c2w[:3, 3].expand_as(rays_d)
    return rays_o, rays_d


def get_rays_at(sel, w, intrinsics, c2w):
    """Rays for a subset of pixels, equal to ``get_rays(...)[sel]``: the
    attack step samples ``n_rand`` of the H*W pixels every iteration and
    builds only their rays.

    :param sel: [N] integer row-major pixel indices (v * w + u)
    :param w: image width
    :param intrinsics, c2w: [4, 4] float32 tensors
    :return: (rays_o [N, 3], rays_d [N, 3])
    """
    u = (sel % w).to(torch.float32)
    v = torch.div(sel, w, rounding_mode="floor").to(torch.float32)
    pixels = torch.stack([u, v, torch.ones_like(u)], dim=0)
    k_inv = torch.linalg.inv(intrinsics[:3, :3])
    rays_d = (c2w[:3, :3] @ (k_inv @ pixels)).T.contiguous()
    rays_o = c2w[:3, 3].expand_as(rays_d)
    return rays_o, rays_d
