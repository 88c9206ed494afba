"""NeRF Synthetic (Blender) dataset.

Behavioral twin of reference ibrnet/data_loaders/nerf_synthetic.py:70-263:
Blender JSON cameras with the blender->opencv flip, alpha compositing onto
white, fixed [2, 6] depth range, PNG depth x10 rescale, total_view_limit
truncation, testskip split over transforms_test.json, global-source selection
by mean camera position.
"""
from __future__ import annotations

import json
import os

import numpy as np

from nerfool_tpu_torch.data.base import Dataset, make_camera
from nerfool_tpu_torch.data.view_selection import (
    get_nearest_pose_ids,
    global_source_ids,
    rectify_inplane_rotation,
)

ALL_SCENES = ("chair", "drums", "lego", "hotdog", "materials", "mic", "ship")


def _imread(path):
    import imageio.v2 as imageio

    return imageio.imread(path).astype(np.float32) / 255.0


def intrinsics_from_hwf(h, w, focal):
    return np.array(
        [[focal, 0, 1.0 * w / 2, 0], [0, focal, 1.0 * h / 2, 0],
         [0, 0, 1, 0], [0, 0, 0, 1]]
    )


def read_cameras(pose_file):
    """Parse a Blender transforms json -> (rgb_files, intrinsics [N,4,4],
    c2w [N,4,4] opencv, depth_files)."""
    basedir = os.path.dirname(pose_file)
    with open(pose_file) as fp:
        meta = json.load(fp)
    camera_angle_x = float(meta["camera_angle_x"])
    first = os.path.join(basedir, meta["frames"][0]["file_path"] + ".png")
    import imageio.v2 as imageio

    h, w = imageio.imread(first).shape[:2]
    focal = 0.5 * w / np.tan(0.5 * camera_angle_x)
    intrinsics = intrinsics_from_hwf(h, w, focal)

    rgb_files, depth_files, c2w_mats = [], [], []
    for frame in meta["frames"]:
        rel = frame["file_path"][2:] if frame["file_path"].startswith("./") else frame["file_path"]
        rgb_files.append(os.path.join(basedir, rel + ".png"))
        depth_file = None
        depth_partial = os.path.basename(rel) + "_depth"
        ddir = os.path.join(basedir, os.path.dirname(rel))
        if os.path.isdir(ddir):
            for fname in sorted(os.listdir(ddir)):
                if depth_partial in fname:
                    depth_file = os.path.join(ddir, fname)
                    break
        depth_files.append(depth_file)
        c2w = np.array(frame["transform_matrix"])
        w2c = np.linalg.inv(c2w)
        w2c[1:3] *= -1  # blender -> opencv
        c2w_mats.append(np.linalg.inv(w2c))
    n = len(meta["frames"])
    return rgb_files, np.array([intrinsics] * n), np.array(c2w_mats), depth_files


def _composite_white(rgba):
    if rgba.shape[-1] == 4:
        return rgba[..., [-1]] * rgba[..., :3] + 1 - rgba[..., [-1]]
    return rgba[..., :3]


class NerfSyntheticDataset(Dataset):
    def __init__(self, args, mode, scenes=(), use_glb_src=False, seed=234, **kwargs):
        self.folder_path = os.path.join(args.rootdir, "data/nerf_synthetic/")
        self.rectify = getattr(args, "rectify_inplane_rotation", False)
        if mode == "validation":
            mode = "val"
        assert mode in ("train", "val", "test")
        self.mode = mode
        self.num_source_views = args.num_source_views
        self.testskip = args.testskip
        self.use_glb_src = use_glb_src
        self.rng = np.random.RandomState(seed)

        if isinstance(scenes, str):
            scenes = [scenes]
        scenes = scenes or ALL_SCENES

        self.render_rgb_files, self.render_poses = [], []
        self.render_intrinsics, self.render_depth_files = [], []
        self.train_rgb_files, self.train_poses = [], []
        self.train_intrinsics, self.train_depth_files = [], []

        for scene in scenes:
            scene_path = os.path.join(self.folder_path, scene)
            pose_file = os.path.join(scene_path, "transforms_test.json")
            rgb_files, intrinsics, poses, depth_files = read_cameras(pose_file)
            limit = getattr(args, "total_view_limit", None)
            if limit is not None:
                rgb_files, intrinsics = rgb_files[:limit], intrinsics[:limit]
                poses, depth_files = poses[:limit], depth_files[:limit]

            i_test = np.arange(len(rgb_files))[:: self.testskip]
            i_train = np.array([j for j in range(len(rgb_files)) if j not in i_test])
            i_render = i_train if mode == "train" else i_test

            for i in range(len(rgb_files)):
                if i in i_render:
                    self.render_rgb_files.append(rgb_files[i])
                    self.render_intrinsics.append(intrinsics[i])
                    self.render_poses.append(poses[i])
                    self.render_depth_files.append(depth_files[i])
                if i in i_train:
                    self.train_rgb_files.append(rgb_files[i])
                    self.train_intrinsics.append(intrinsics[i])
                    self.train_poses.append(poses[i])
                    self.train_depth_files.append(depth_files[i])

        self.has_depth = all(f is not None for f in self.render_depth_files)

    def __len__(self):
        return len(self.render_rgb_files)

    def __getitem__(self, idx):
        rgb_file = self.render_rgb_files[idx]
        render_pose = self.render_poses[idx]
        intrinsics = self.render_intrinsics[idx]
        train_poses = np.stack(self.train_poses, axis=0)

        if self.mode == "train":
            id_render = (
                self.train_rgb_files.index(rgb_file)
                if rgb_file in self.train_rgb_files else -1
            )
            subsample = self.rng.choice(np.arange(1, 4), p=[0.3, 0.5, 0.2])
        else:
            id_render = -1
            subsample = 1

        rgb = _composite_white(_imread(rgb_file))
        camera = make_camera(*rgb.shape[:2], intrinsics, render_pose)

        if self.use_glb_src:
            nearest_ids = global_source_ids(train_poses, self.num_source_views)
        else:
            nearest_ids = get_nearest_pose_ids(
                render_pose, train_poses, int(self.num_source_views * subsample),
                tar_id=id_render, angular_dist_method="vector",
            )
            nearest_ids = self.rng.choice(nearest_ids, self.num_source_views, replace=False)
        assert id_render not in nearest_ids
        if self.mode == "train" and self.rng.choice([0, 1], p=[0.995, 0.005]):
            nearest_ids[self.rng.choice(len(nearest_ids))] = id_render

        src_rgbs, src_cameras, src_depths = [], [], []
        for vid in nearest_ids:
            src_rgb = _composite_white(_imread(self.train_rgb_files[vid]))
            pose = self.train_poses[vid]
            if self.rectify:
                pose, src_rgb = rectify_inplane_rotation(pose, render_pose, src_rgb)
            src_rgbs.append(src_rgb)
            src_cameras.append(
                make_camera(*src_rgb.shape[:2], self.train_intrinsics[vid], pose)
            )
            if self.has_depth:
                d = _imread(self.train_depth_files[vid])
                src_depths.append((d[..., 0] if d.ndim == 3 else d) * 10.0)

        data = {
            "rgb": rgb.astype(np.float32),
            "camera": camera,
            "rgb_path": rgb_file,
            "src_rgbs": np.stack(src_rgbs).astype(np.float32),
            "src_cameras": np.stack(src_cameras),
            "depth_range": np.array([2.0, 6.0], dtype=np.float32),
        }
        if self.has_depth:
            d = _imread(self.render_depth_files[idx])
            data["depth"] = ((d[..., 0] if d.ndim == 3 else d) * 10.0).astype(np.float32)
            data["src_depths"] = np.stack(src_depths).astype(np.float32)
        return data
