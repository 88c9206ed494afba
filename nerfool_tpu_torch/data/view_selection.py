"""Source-view selection and pose-distance utilities.

Numpy re-derivation of reference ibrnet/data_loaders/data_utils.py:
angular-distance metrics, nearest-view selection (three modes), in-plane
rotation rectification, and the crop/flip augmentations.
"""
from __future__ import annotations

import numpy as np

TINY = 1e-6


def angular_dist_between_2_vectors(vec1, vec2):
    v1 = vec1 / (np.linalg.norm(vec1, axis=1, keepdims=True) + TINY)
    v2 = vec2 / (np.linalg.norm(vec2, axis=1, keepdims=True) + TINY)
    return np.arccos(np.clip(np.sum(v1 * v2, axis=-1), -1.0, 1.0))


def batched_angular_dist_rot_matrix(r1, r2):
    """Angular distance between rotation matrices [N,3,3]."""
    tr = np.trace(np.matmul(r2.transpose(0, 2, 1), r1), axis1=1, axis2=2)
    return np.arccos(np.clip((tr - 1) / 2.0, -1 + TINY, 1 - TINY))


def get_nearest_pose_ids(tar_pose, ref_poses, num_select, tar_id=-1,
                         angular_dist_method="vector", scene_center=(0, 0, 0)):
    """Select the num_select reference views nearest the target pose.

    Modes: 'matrix' (rotation distance), 'vector' (angle around scene center),
    'dist' (camera-position distance).
    """
    num_cams = len(ref_poses)
    num_select = min(num_select, num_cams - 1)
    batched_tar = np.broadcast_to(tar_pose, (num_cams,) + tar_pose.shape)
    if angular_dist_method == "matrix":
        dists = batched_angular_dist_rot_matrix(
            batched_tar[:, :3, :3], ref_poses[:, :3, :3]
        )
    elif angular_dist_method == "vector":
        center = np.asarray(scene_center)[None]
        dists = angular_dist_between_2_vectors(
            batched_tar[:, :3, 3] - center, ref_poses[:, :3, 3] - center
        )
    elif angular_dist_method == "dist":
        dists = np.linalg.norm(batched_tar[:, :3, 3] - ref_poses[:, :3, 3], axis=1)
    else:
        raise ValueError(angular_dist_method)

    if tar_id >= 0:
        assert tar_id < num_cams
        dists = dists.copy()
        dists[tar_id] = 1e3
    return np.argsort(dists)[:num_select]


def global_source_ids(train_poses, num_select):
    """Views nearest the mean camera position (L1) — the universal attack's
    global source set (llff_test.py:131-134, use_glb_src)."""
    ref = np.mean(train_poses[..., 3], axis=0, keepdims=True)
    dist = np.sum(np.abs(train_poses[..., 3] - ref), axis=-1)
    return np.argsort(dist)[:num_select]


def rectify_inplane_rotation(src_pose, tar_pose, src_img, th=40):
    """Rotate a source view so its in-plane (roll) angle matches the target."""
    import cv2
    from scipy.spatial.transform import Rotation as R

    relative = np.linalg.inv(tar_pose).dot(src_pose)
    euler_z = R.from_matrix(relative[:3, :3]).as_euler("zxy", degrees=True)[0]
    if np.abs(euler_z) < th:
        return src_pose, src_img
    r_rect = R.from_euler("z", -euler_z, degrees=True).as_matrix()
    out_pose = np.eye(4)
    out_pose[:3, :3] = src_pose[:3, :3].dot(r_rect)
    out_pose[:3, 3:4] = src_pose[:3, 3:4]
    h, w = src_img.shape[:2]
    center = ((w - 1.0) / 2.0, (h - 1.0) / 2.0)
    m = cv2.getRotationMatrix2D(center, -euler_z, 1)
    img8 = np.clip((255 * src_img).astype(np.uint8), 0, 255)
    rotated = cv2.warpAffine(
        img8, m, (w, h), borderValue=(255, 255, 255), flags=cv2.INTER_LANCZOS4
    )
    return out_pose, rotated.astype(np.float32) / 255.0


def random_crop(rng, rgb, camera, src_rgbs, src_cameras, size=(400, 600),
                center=None, src_depths=None):
    """Crop target + all sources to ``size``, fixing principal points."""
    h, w = rgb.shape[:2]
    out_h, out_w = size
    if out_w >= w or out_h >= h:
        return (rgb, camera, src_rgbs, src_cameras) + (
            (src_depths,) if src_depths is not None else ()
        )
    if center is not None:
        ch, cw = center
    else:
        ch = rng.randint(out_h // 2 + 1, h - out_h // 2 - 1)
        cw = rng.randint(out_w // 2 + 1, w - out_w // 2 - 1)
    ys, xs = ch - out_h // 2, cw - out_w // 2
    rgb_out = rgb[ys:ys + out_h, xs:xs + out_w]
    src_rgbs = np.asarray(src_rgbs)[:, ys:ys + out_h, xs:xs + out_w]
    camera = camera.copy()
    src_cameras = src_cameras.copy()
    camera[0], camera[1] = out_h, out_w
    camera[4] -= xs
    camera[8] -= ys
    src_cameras[:, 4] -= xs
    src_cameras[:, 8] -= ys
    src_cameras[:, 0], src_cameras[:, 1] = out_h, out_w
    if src_depths is not None:
        src_depths = np.asarray(src_depths)[:, ys:ys + out_h, xs:xs + out_w]
        return rgb_out, camera, src_rgbs, src_cameras, src_depths
    return rgb_out, camera, src_rgbs, src_cameras


def random_flip(rgb, camera, src_rgbs, src_cameras):
    """Horizontal flip of target + sources (negated fx, mirrored cx)."""
    h, w = rgb.shape[:2]
    w_r = src_rgbs.shape[2]
    rgb_out = np.flip(rgb, axis=1).copy()
    src_rgbs = np.flip(src_rgbs, axis=-2).copy()
    camera = camera.copy()
    src_cameras = src_cameras.copy()
    camera[2] *= -1
    camera[4] = w - 1.0 - camera[4]
    src_cameras[:, 2] *= -1
    src_cameras[:, 4] = w_r - 1.0 - src_cameras[:, 4]
    return rgb_out, camera, src_rgbs, src_cameras
