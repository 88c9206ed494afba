"""Spaces dataset (multi-rig models.json scenes), free-viewpoint training mode.

Behavioral twin of reference ibrnet/data_loaders/spaces_dataset.py:
json view parsing (angle-axis world-from-camera, focal/aspect intrinsics),
forward-direction-angle view sorting, per-view padding to the max image size,
crop/flip augmentation, fixed [0.7, 100] depth range.
"""
from __future__ import annotations

import json
import os

import numpy as np

from nerfool_tpu_torch.data.base import Dataset
from nerfool_tpu_torch.data.view_selection import random_crop, random_flip


def _imread(path):
    import imageio.v2 as imageio

    return imageio.imread(path).astype(np.float32) / 255.0


def _axis_angle_rotation(angle_axis):
    angle = np.linalg.norm(angle_axis)
    if abs(angle) < 1e-7:
        return np.eye(3)
    axis = angle_axis / angle
    # quaternion for rotation of -angle about axis (reference uses -angle)
    half = -angle / 2.0
    q = np.concatenate([axis * np.sin(half), [np.cos(half)]])
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


class View:
    def __init__(self, image_path, shape, intrinsics, w_f_c):
        self.image_path = image_path
        self.shape = shape
        self.intrinsics = intrinsics  # 3x3
        self.w_f_c = w_f_c  # world-from-camera 4x4 (= c2w)


def read_view(base_dir, vj):
    transform = np.identity(4)
    transform[0:3, 3] = vj["position"]
    transform[0:3, 0:3] = _axis_angle_rotation(np.array(vj["orientation"]))
    intr = np.identity(3)
    intr[0, 0] = vj["focal_length"]
    intr[1, 1] = vj["focal_length"] * vj["pixel_aspect_ratio"]
    intr[0, 2] = vj["principal_point"][0]
    intr[1, 2] = vj["principal_point"][1]
    return View(
        os.path.join(base_dir, vj["relative_path"]),
        (int(vj["height"]), int(vj["width"])), intr, transform,
    )


def read_scene(base_dir):
    with open(os.path.join(base_dir, "models.json")) as f:
        model_json = json.load(f)
    return [[read_view(base_dir, vj) for vj in views] for views in model_json]


def sort_nearby_views_by_angle(query_pose, ref_poses):
    qd = np.sum(query_pose[:3, 2:4], axis=-1)
    qd = qd / np.linalg.norm(qd)
    rd = np.sum(ref_poses[:, :3, 2:4], axis=-1)
    rd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    return np.argsort(np.sum(rd * qd[None], axis=1))[::-1]


def _view_to_camera(view):
    intr44 = np.eye(4)
    intr44[:3, :3] = view.intrinsics
    return np.concatenate(
        [np.array(view.shape, np.float64), intr44.reshape(-1), view.w_f_c.reshape(-1)]
    ).astype(np.float32)


class SpacesFreeDataset(Dataset):
    def __init__(self, args, mode, seed=234, **kwargs):
        self.folder_path = os.path.join(args.rootdir, "data/spaces_dataset/data/800/")
        self.mode = mode
        self.num_source_views = args.num_source_views
        self.random_crop_on = True
        self.rng = np.random.RandomState(seed)
        eval_ids: list = []
        ids = [i for i in range(100) if i not in eval_ids] if mode == "train" else eval_ids
        self.scene_dirs = [
            os.path.join(self.folder_path, f"scene_{i:03d}") for i in ids
        ]
        self.all_views_scenes = []
        self.all_flat = []  # (rgb_paths, img_sizes, intrinsics, c2w) per scene
        for sd in self.scene_dirs:
            views = read_scene(sd)
            self.all_views_scenes.append(views)
            flat = [v for rig in views for v in rig]
            self.all_flat.append(
                (
                    [v.image_path for v in flat],
                    [v.shape for v in flat],
                    [v.intrinsics.copy() for v in flat],
                    np.stack([v.w_f_c for v in flat]),
                )
            )

    def __len__(self):
        return len(self.all_views_scenes)

    def __getitem__(self, idx):
        views = self.all_views_scenes[idx]
        rig = views[self.rng.randint(0, len(views))]
        cam = rig[self.rng.choice(16)]
        render_rgb = _imread(cam.image_path)[..., :3]
        render_camera = _view_to_camera(cam)
        render_camera[:2] = render_rgb.shape[:2]

        rgb_paths, img_sizes, intrinsics_list, c2w_mats = self.all_flat[idx]
        sorted_ids = sort_nearby_views_by_angle(
            render_camera[-16:].reshape(4, 4), c2w_mats
        )
        sel = self.rng.choice(sorted_ids[1:], self.num_source_views, replace=False)

        ref_rgbs, ref_cameras = [], []
        h_max = w_max = 0
        for vid in sel:
            rgb = _imread(rgb_paths[vid])[..., :3]
            h_in, w_in = img_sizes[vid]
            h_img, w_img = rgb.shape[:2]
            intr = intrinsics_list[vid].copy()
            if h_in != h_img or w_in != w_img:
                intr[0] *= w_img / w_in
                intr[1] *= h_img / h_in
            intr44 = np.eye(4)
            intr44[:3, :3] = intr
            ref_cameras.append(
                np.concatenate(
                    [np.array([h_img, w_img], np.float64), intr44.reshape(-1),
                     c2w_mats[vid].reshape(-1)]
                )
            )
            ref_rgbs.append(rgb)
            h_max, w_max = max(h_max, h_img), max(w_max, w_img)

        padded = np.ones((len(ref_rgbs), h_max, w_max, 3), dtype=np.float32)
        for i, rgb in enumerate(ref_rgbs):
            oh, ow = rgb.shape[:2]
            hs, ws = int((h_max - oh) / 2), int((w_max - ow) / 2)
            padded[i, hs:hs + oh, ws:ws + ow] = rgb
            ref_cameras[i][4] += (w_max - ow) / 2.0
            ref_cameras[i][8] += (h_max - oh) / 2.0
            ref_cameras[i][0], ref_cameras[i][1] = h_max, w_max
        ref_cameras = np.array(ref_cameras, dtype=np.float32)

        if self.mode == "train" and self.random_crop_on:
            render_rgb, render_camera, padded, ref_cameras = random_crop(
                self.rng, render_rgb, render_camera, padded, ref_cameras
            )
        if self.mode == "train" and self.rng.choice([0, 1]):
            render_rgb, render_camera, padded, ref_cameras = random_flip(
                render_rgb, render_camera, padded, ref_cameras
            )
        return {
            "rgb": render_rgb.astype(np.float32),
            "camera": render_camera.astype(np.float32),
            "rgb_path": cam.image_path,
            "src_rgbs": padded,
            "src_cameras": ref_cameras,
            "depth_range": np.array([0.7, 100.0], dtype=np.float32),
        }
