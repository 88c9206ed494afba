"""Depth-based warping between views (port of
``nerfool_tpu/attack/warp.py``): unproject a depth map, reproject it into
another camera, and z-buffer the landing pixels.

The z-buffer is two scatter-min passes (``Tensor.scatter_reduce`` with
``"amin"``): the nearest depth per landing pixel, then the lowest source
index among the pixels at that depth, so ties go to the lowest source index
as in the reference's loop. Winner selection runs without gradient; the
chosen depths keep theirs, so the camera-pose attack differentiates through
the warp. Each source pixel then adds its values into its landing pixel if
it won there and zeros otherwise, so a pixel's sum is its winner's value.
Neither a min nor a sum of one value and zeros depends on the order in which
the scatters' atomics land, so the result is the same from run to run on
the card; and the sum's backward is a gather, where gathering the winners'
values would scatter its gradient back onto the one index that all pixels
hit by nothing share.
"""
from __future__ import annotations

import torch


def _inv(m):
    """Matrix inverse without ``torch.linalg.inv``'s error check, which
    waits for the card."""
    return torch.linalg.inv_ex(m)[0]


def project_with_depth(depth_ref, intrinsics_ref, extrinsics_ref,
                       intrinsics_src, extrinsics_src):
    """Unproject a depth map and reproject it into another camera.

    :param depth_ref: [H, W]
    :param intrinsics_*: [3, 3]; extrinsics_*: [4, 4] (c2w)
    :return: (x_src [H*W], y_src [H*W], depth_src [H*W]) continuous pixel
        coordinates and depth in the src camera frame
    """
    h, w = depth_ref.shape
    dt, dev = depth_ref.dtype, depth_ref.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dt, device=dev),
                            torch.arange(w, dtype=dt, device=dev),
                            indexing="ij")
    ones = torch.ones(h * w, dtype=dt, device=dev)
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1), ones])
    xyz_ref = _inv(intrinsics_ref) @ (pix * depth_ref.reshape(1, -1))
    xyz_ref_h = torch.cat([xyz_ref, ones[None]])
    rel = _inv(extrinsics_src) @ extrinsics_ref
    k_xyz = intrinsics_src @ (rel @ xyz_ref_h)[:3]
    xy = k_xyz[:2] / (k_xyz[2:3] + 1e-9)
    return xy[0], xy[1], k_xyz[2]


def _zbuffer_scatter(tgt_idx, depth_vals, rgb_vals, num_pixels):
    """First-minimum-wins z-buffer scatter.

    :param tgt_idx: [P] int64 flat destination indices
    :param depth_vals: [P] depths (differentiable)
    :param rgb_vals: [P, 3], or None
    :return: (new_rgb [num_pixels, 3] or None, new_depth [num_pixels]),
        zeros where nothing lands
    """
    p = depth_vals.shape[0]
    d = depth_vals.detach()
    best = d.new_full((num_pixels,), float("inf")).scatter_reduce(
        0, tgt_idx, d, "amin", include_self=False)
    order = torch.arange(p, device=d.device)
    candidate = torch.where(d == best[tgt_idx], order, p)
    winner = torch.full((num_pixels,), p, device=d.device).scatter_reduce(
        0, tgt_idx, candidate, "amin", include_self=False)
    won = winner[tgt_idx] == order
    new_depth = depth_vals.new_zeros(num_pixels).scatter_add(
        0, tgt_idx, torch.where(won, depth_vals, 0.0))
    new_rgb = None if rgb_vals is None else rgb_vals.new_zeros(
        (num_pixels, 3)).scatter_add(0, tgt_idx[:, None].expand(-1, 3),
                                     torch.where(won[:, None], rgb_vals, 0.0))
    return new_rgb, new_depth


def forward_warp(selected_inds, rgb_ref, depth_ref, intrinsics_ref,
                 extrinsics_ref, intrinsics_src, extrinsics_src, src2tar=True,
                 derive_full_image=False):
    """Warp ``rgb_ref`` / ``depth_ref`` into the src camera with z-buffering.
    ``rgb_ref`` may be None where only depths are read; the rgb outputs are
    then None.

    src2tar=True: a z-buffer over the whole frame, read at
    ``selected_inds`` of the destination. Returns (rgb_full [H, W, 3],
    depth_full [H, W], rgb_proj [N, 3], depth_proj [N]); without
    ``derive_full_image`` the full maps keep only the selected pixels.

    src2tar=False: only the ``selected_inds`` pixels of the reference view
    are warped; returns additionally each selected pixel's landing index in
    the destination: (rgb_full, depth_full, rgb_proj, depth_proj, inds_new).
    """
    h, w = depth_ref.shape
    num_pixels = h * w
    x_res, y_res, depth_src = project_with_depth(
        depth_ref, intrinsics_ref, extrinsics_ref, intrinsics_src,
        extrinsics_src)
    x_i = torch.clamp(x_res.detach(), 0, w - 1).long()
    y_i = torch.clamp(y_res.detach(), 0, h - 1).long()
    tgt_idx = y_i * w + x_i
    rgb_flat = None if rgb_ref is None else rgb_ref.reshape(-1, 3)

    def images(new_rgb, new_depth):
        return (None if new_rgb is None else new_rgb.reshape(h, w, 3),
                new_depth.reshape(h, w))

    if src2tar or derive_full_image:
        new_rgb, new_depth = _zbuffer_scatter(tgt_idx, depth_src, rgb_flat,
                                              num_pixels)
        rgb_proj = None if new_rgb is None else new_rgb[selected_inds]
        depth_proj = new_depth[selected_inds]
        if not derive_full_image:
            # the reference's src2tar loop writes only the pixels landing in
            # selected_inds
            keep = torch.zeros(num_pixels, dtype=torch.bool,
                               device=depth_ref.device)
            keep[selected_inds] = True
            new_depth = torch.where(keep, new_depth, 0.0)
            if new_rgb is not None:
                new_rgb = torch.where(keep[:, None], new_rgb, 0.0)
        return (*images(new_rgb, new_depth), rgb_proj, depth_proj)

    inds_new = tgt_idx[selected_inds]
    new_rgb, new_depth = _zbuffer_scatter(
        inds_new, depth_src[selected_inds],
        None if rgb_flat is None else rgb_flat[selected_inds], num_pixels)
    rgb_proj = None if new_rgb is None else new_rgb[inds_new]
    return (*images(new_rgb, new_depth), rgb_proj, new_depth[inds_new],
            inds_new)
