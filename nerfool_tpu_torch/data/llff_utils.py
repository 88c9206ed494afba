"""LLFF (COLMAP-processed forward-facing) scene loading.

Re-derivation of the LLFF pipeline used by the reference
(reference ibrnet/data_loaders/llff_data_utils.py): poses_bounds.npy
parsing, pose-convention fix, bound rescale, recentering, spherification, and
the spiral render path. Differences from the reference: image downscaling uses
cv2 (area) instead of shelling out to ImageMagick ``mogrify``, and everything is
pure numpy (no torch).
"""
from __future__ import annotations

import os

import numpy as np


def imread(path):
    """An image file as a uint8 array, through imageio where it imports;
    without it (the card's machine has no imaging package) a PNG of 8-bit
    samples goes through the port's own reader (``utils/vis.read_png``)."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        if not str(path).lower().endswith(".png"):
            raise
        from nerfool_tpu_torch.utils.vis import read_png

        img = read_png(path)
        return img[..., 0] if img.shape[-1] == 1 else img
    return imageio.imread(path)


def _imwrite(path, img):
    import imageio.v2 as imageio

    imageio.imwrite(path, img)


def parse_llff_pose(pose):
    """LLFF [3,5] pose -> (intrinsics [4,4], c2w [4,4]) in OpenCV convention
    (the [down, right, back] -> [right, up, back] axis flip: c2w[:,1:3] *= -1)."""
    h, w, f = pose[:3, -1]
    c2w = np.eye(4)
    c2w[:3] = pose[:3, :4]
    c2w[:, 1:3] *= -1
    intrinsics = np.array(
        [[f, 0, w / 2.0, 0], [0, f, h / 2.0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]
    )
    return intrinsics, c2w


def batch_parse_llff_poses(poses):
    ks, c2ws = zip(*[parse_llff_pose(p) for p in poses])
    return np.stack(ks), np.stack(c2ws)


def _minify(basedir, factor):
    """Create images_{factor}/ with cv2 area downscaling (ImageMagick-free)."""
    import cv2

    imgdir = os.path.join(basedir, f"images_{factor}")
    if os.path.exists(imgdir):
        return
    src_dir = os.path.join(basedir, "images")
    files = sorted(
        f for f in os.listdir(src_dir)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    os.makedirs(imgdir)
    for f in files:
        img = imread(os.path.join(src_dir, f))
        h, w = img.shape[:2]
        out = cv2.resize(
            img, (int(round(w / factor)), int(round(h / factor))),
            interpolation=cv2.INTER_AREA,
        )
        _imwrite(os.path.join(imgdir, os.path.splitext(f)[0] + ".png"), out)


def _load_data(basedir, factor=None, load_imgs=True):
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    sfx = ""
    if factor is not None and factor != 1:
        sfx = f"_{factor}"
        _minify(basedir, factor)
    else:
        factor = 1

    imgdir = os.path.join(basedir, "images" + sfx)
    if not os.path.exists(imgdir):
        raise FileNotFoundError(imgdir)
    imgfiles = [
        os.path.join(imgdir, f)
        for f in sorted(os.listdir(imgdir))
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    ]
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(
            f"{basedir}: {len(imgfiles)} images vs {poses.shape[-1]} poses"
        )

    sh = imread(imgfiles[0]).shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor

    imgs = None
    if load_imgs:
        imgs = np.stack(
            [imread(f)[..., :3] / 255.0 for f in imgfiles], -1
        )
    return poses, bds, imgs, imgfiles


def normalize(x):
    return x / np.linalg.norm(x)


def viewmatrix(z, up, pos):
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses):
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], 1)


def render_path_spiral(c2w, up, rads, focal, zdelta, zrate, rots, n):
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n + 1)[:-1]:
        c = np.dot(
            c2w[:3, :4],
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * rads,
        )
        z = normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(np.concatenate([viewmatrix(z, up, c), hwf], 1))
    return render_poses


def recenter_poses(poses):
    poses_ = poses + 0
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    p44 = np.concatenate([poses[:, :3, :4], bottom], -2)
    p44 = np.linalg.inv(c2w) @ p44
    poses_[:, :3, :4] = p44[:, :3, :4]
    return poses_


def spherify_poses(poses, bds):
    def p34_to_44(p):
        return np.concatenate(
            [p, np.tile(np.reshape(np.eye(4)[-1], [1, 1, 4]), [p.shape[0], 1, 1])], 1
        )

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]
    a_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -a_i @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((np.transpose(a_i, [0, 2, 1]) @ a_i).mean(0)) @ b_i.mean(0)
    )
    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = normalize(up)
    vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad ** 2 - zh ** 2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = normalize(camorigin)
        vec0 = normalize(np.cross(vec2, up))
        vec1 = normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], 1))
    new_poses = np.stack(new_poses, 0)
    new_poses = np.concatenate(
        [new_poses, np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)], -1
    )
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4],
         np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape)], -1
    )
    return poses_reset, new_poses, bds


def load_llff_data(basedir, factor=8, recenter=True, bd_factor=0.75,
                   spherify=False, path_zflat=False, load_imgs=True):
    """Returns (images, poses [N,3,5], bds [N,2], render_poses, i_test, imgfiles)."""
    poses, bds, imgs, imgfiles = _load_data(basedir, factor=factor, load_imgs=load_imgs)

    # [down, right, back] -> [right, up, back] reorder
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    images = np.moveaxis(imgs, -1, 0).astype(np.float32) if imgs is not None else None
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = poses_avg(poses)
        up = normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        zdelta = close_depth * 0.2
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        c2w_path = c2w
        n_views, n_rots = 120, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            n_rots = 1
            n_views //= 2
        render_poses = render_path_spiral(
            c2w_path, up, rads, focal, zdelta, zrate=0.5, rots=n_rots, n=n_views
        )

    render_poses = np.array(render_poses).astype(np.float32)
    c2w = poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))
    return images, poses.astype(np.float32), bds, render_poses, i_test, imgfiles
