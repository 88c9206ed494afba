"""Epipolar projection of ray sample points into source views (port of
``nerfool_tpu/render/projection.py``).

Intermediates are component-wise ``[V, P]`` planes, as in the JAX package, so
the two are compared plane for plane. ``gather_bilinear_planes`` is the
per-tap bilinear gather (``F.grid_sample``, align_corners=True, zeros
padding): the reference's own op, the per-tap render route, and the CPU oracle
that the BSPG selection is held to.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from nerfool_tpu_torch.utils.numerics import sqrt

TINY = 1e-6


def _camera_mats(src_cameras):
    intr = src_cameras[:, 2:18].reshape(-1, 4, 4)
    c2w = src_cameras[:, 18:34].reshape(-1, 4, 4)
    proj = intr @ torch.linalg.inv_ex(c2w).inverse  # [V, 4, 4]
    return proj, c2w


def project_points_planes(xyz_flat, src_cameras):
    """Project [P, 3] points into each source camera, component-wise.

    :return: (pix_x [V, P], pix_y [V, P], in_front [V, P] bool)
    """
    proj, _ = _camera_mats(src_cameras)
    x, y, z = xyz_flat[:, 0], xyz_flat[:, 1], xyz_flat[:, 2]

    def row(i):
        return (proj[:, i, 0, None] * x + proj[:, i, 1, None] * y
                + proj[:, i, 2, None] * z + proj[:, i, 3, None])

    px, py, pz = row(0), row(1), row(2)
    denom = torch.clamp(pz, min=1e-8)
    pix_x = torch.clamp(px / denom, -1e6, 1e6)
    pix_y = torch.clamp(py / denom, -1e6, 1e6)
    return pix_x, pix_y, pz > 0


def compute_angle_planes(xyz_flat, query_camera, src_cameras):
    """Ray-direction difference features, component-wise.

    :return: (dx, dy, dz, dot) each [V, P]
    """
    src_c2w = src_cameras[:, 18:34].reshape(-1, 4, 4)
    q_c2w = query_camera[18:34].reshape(4, 4)
    x, y, z = xyz_flat[:, 0], xyz_flat[:, 1], xyz_flat[:, 2]

    # unit vector point -> query camera ([P] planes, view-independent)
    tx = q_c2w[0, 3] - x
    ty = q_c2w[1, 3] - y
    tz = q_c2w[2, 3] - z
    tn = sqrt(tx * tx + ty * ty + tz * tz) + TINY
    tx, ty, tz = tx / tn, ty / tn, tz / tn

    # unit vector point -> each source camera ([V, P] planes)
    sx = src_c2w[:, 0, 3, None] - x
    sy = src_c2w[:, 1, 3, None] - y
    sz = src_c2w[:, 2, 3, None] - z
    sn = sqrt(sx * sx + sy * sy + sz * sz) + TINY
    sx, sy, sz = sx / sn, sy / sn, sz / sn

    dx = tx - sx
    dy = ty - sy
    dz = tz - sz
    dn = torch.clamp(sqrt(dx * dx + dy * dy + dz * dz), min=TINY)
    dot = tx * sx + ty * sy + tz * sz
    return dx / dn, dy / dn, dz / dn, dot


def inbound_mask_planes(pix_x, pix_y, h, w):
    return (pix_x <= w - 1.0) & (pix_x >= 0) & (pix_y <= h - 1.0) & (pix_y >= 0)


def gather_bilinear_planes(images, gx, gy):
    """Per-tap bilinear gather of every view at normalized coordinates.

    :param images: [V, H, W, C] (NHWC)
    :param gx, gy: [V, P] normalized [-1, 1] coords (align_corners=True:
        -1 is pixel 0, +1 is pixel W-1 / H-1); out-of-range corners add zero
    :return: [V, P, C]
    """
    grid = torch.stack([gx, gy], dim=-1)[:, None]  # [V, 1, P, 2]
    out = F.grid_sample(images.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[:, :, 0].transpose(1, 2)  # [V, C, 1, P] -> [V, P, C]


def epipolar_gather_components(xyz, query_camera, src_rgbs, src_cameras,
                               featmaps):
    """Project sample points into all source views; gather colors and
    features per tap.

    :param xyz: [R, S, 3] sample points
    :param query_camera: [34] target camera
    :param src_rgbs: [V, H, W, 3]
    :param src_cameras: [V, 34]
    :param featmaps: [V, Hf, Wf, C] (normalized coords make the gather
        resolution-agnostic, as in F.grid_sample)
    :return: (rgb [V, R, S, 3], feat [V, R, S, C], ray_diff [V, R, S, 4],
              mask [V, R, S, 1] float)
    """
    h = src_cameras[0, 0]
    w = src_cameras[0, 1]
    lead = xyz.shape[:-1]
    v = src_cameras.shape[0]
    pts = xyz.reshape(-1, 3)

    pix_x, pix_y, in_front = project_points_planes(pts, src_cameras)
    gx = 2.0 * pix_x / (w - 1.0) - 1.0
    gy = 2.0 * pix_y / (h - 1.0) - 1.0
    rgb = gather_bilinear_planes(src_rgbs, gx, gy).reshape((v,) + lead + (-1,))
    feat = gather_bilinear_planes(featmaps, gx, gy).reshape((v,) + lead + (-1,))

    dx, dy, dz, dot = compute_angle_planes(pts, query_camera, src_cameras)
    ray_diff = torch.stack([dx, dy, dz, dot], dim=-1).reshape((v,) + lead + (4,))
    mask = (inbound_mask_planes(pix_x, pix_y, h, w) & in_front).to(
        rgb.dtype).reshape((v,) + lead + (1,))
    return rgb, feat, ray_diff, mask
