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
    :param intrinsics, c2w: [4, 4] float tensors (the rays' dtype)
    :return: (rays_o [N, 3], rays_d [N, 3])
    """
    u = (sel % w).to(intrinsics.dtype)
    v = torch.div(sel, w, rounding_mode="floor").to(intrinsics.dtype)
    pixels = torch.stack([u, v, torch.ones_like(u)], dim=0)
    k_inv = torch.linalg.inv(intrinsics[:3, :3])
    rays_d = (c2w[:3, :3] @ (k_inv @ pixels)).T.contiguous()
    rays_o = c2w[:3, 3].expand_as(rays_d)
    return rays_o, rays_d


def rotation_matrix_from_euler(rot):
    """Differentiable rotation matrix from 3 angles (radians), ``R = Rz(dz)
    @ Ry(dy) @ Rx(dx)`` with the reference's per-axis layouts: it names them
    rot_x / rot_y / rot_z but builds a rotation about z from ``dx``, about y
    from ``dy`` and about x from ``dz``; replicated.

    :param rot: [..., 3]
    :return: [..., 3, 3]
    """
    dx, dy, dz = rot[..., 0], rot[..., 1], rot[..., 2]
    zeros, ones = torch.zeros_like(dx), torch.ones_like(dx)
    cx, sx = torch.cos(dx), torch.sin(dx)
    cy, sy = torch.cos(dy), torch.sin(dy)
    cz, sz = torch.cos(dz), torch.sin(dz)
    mat = lambda *rows: torch.stack(rows, dim=-1).reshape(dx.shape + (3, 3))
    rot_x = mat(cx, -sx, zeros, sx, cx, zeros, zeros, zeros, ones)
    rot_y = mat(cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy)
    rot_z = mat(ones, zeros, zeros, zeros, cz, -sz, zeros, sz, cz)
    return rot_z @ rot_y @ rot_x


def transform_src_cameras(src_cameras, rot, trans):
    """Apply per-view rotation and translation perturbations to source
    cameras: the rotations are left-multiplied onto the c2w rotation block,
    the translations added to its last column, and the bottom row of the
    4x4 keeps its values. Differentiable in ``rot`` and ``trans``.

    :param src_cameras: [V, 34]
    :param rot: [V, 3] angles (radians); trans: [V, 3]
    :return: [V, 34] perturbed camera vectors
    """
    c2w = src_cameras[:, 18:34].reshape(-1, 4, 4)
    rot_new = rotation_matrix_from_euler(rot) @ c2w[:, :3, :3]
    trans_new = c2w[:, :3, 3] + trans
    top = torch.cat([rot_new, trans_new[..., None]], dim=-1).reshape(-1, 12)
    return torch.cat([src_cameras[:, :18], top, src_cameras[:, 30:34]], dim=-1)
