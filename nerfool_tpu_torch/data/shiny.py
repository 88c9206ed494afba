"""Shiny dataset (GNT stack) — LLFF-style scenes with explicit hwf_cxcy.npy
intrinsics. Behavioral twin of reference gnt/data_loaders/shiny.py:13-164
(intrinsics built from fx/fy/cx/cy with the dataset's sign conventions)."""
from __future__ import annotations

import os

import numpy as np

from nerfool_tpu_torch.data.base import Dataset, make_camera
from nerfool_tpu_torch.data.llff_utils import batch_parse_llff_poses, load_llff_data
from nerfool_tpu_torch.data.view_selection import get_nearest_pose_ids, random_crop


def _imread(path):
    import imageio.v2 as imageio

    return imageio.imread(path).astype(np.float32) / 255.0


class ShinyDataset(Dataset):
    def __init__(self, args, mode, scenes=(), random_crop=True, seed=234, **kwargs):
        self.folder_path = os.path.join(args.rootdir, "data/shiny/")
        self.mode = mode
        self.num_source_views = args.num_source_views
        self.random_crop_on = random_crop
        self.rng = np.random.RandomState(seed)

        if isinstance(scenes, str):
            scenes = [scenes]
        scenes = scenes or sorted(os.listdir(self.folder_path))

        self.render_rgb_files, self.render_intrinsics = [], []
        self.render_poses, self.render_train_set_ids = [], []
        self.render_depth_range = []
        self.train_intrinsics, self.train_poses, self.train_rgb_files = [], [], []

        for i, scene in enumerate(scenes):
            scene_path = os.path.join(self.folder_path, scene)
            _, poses, bds, _, _, rgb_files = load_llff_data(
                scene_path, load_imgs=False, factor=4
            )
            near_depth, far_depth = float(np.min(bds)), float(np.max(bds))
            _, c2w_mats = batch_parse_llff_poses(poses)
            arr = np.load(os.path.join(scene_path, "hwf_cxcy.npy"))
            _, _, fx, fy, cx, cy = arr[:, 0]
            intr = np.array(
                [[fx, 0, -cx, 0], [0, -fy, -cy, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                dtype=np.float32,
            )
            intrinsics = np.repeat(intr[None], poses.shape[0], axis=0)

            i_test = np.arange(poses.shape[0])[:: args.llffhold]
            i_train = np.array(
                [j for j in np.arange(poses.shape[0]) if j not in i_test]
            )
            i_render = i_train if mode == "train" else i_test

            self.train_intrinsics.append(intrinsics[i_train])
            self.train_poses.append(c2w_mats[i_train])
            self.train_rgb_files.append(np.array(rgb_files)[i_train].tolist())
            n = len(i_render)
            self.render_rgb_files.extend(np.array(rgb_files)[i_render].tolist())
            self.render_intrinsics.extend(list(intrinsics[i_render]))
            self.render_poses.extend(list(c2w_mats[i_render]))
            self.render_depth_range.extend([[near_depth, far_depth]] * n)
            self.render_train_set_ids.extend([i] * n)

    def __len__(self):
        n = len(self.render_rgb_files)
        return n * 100000 if self.mode == "train" else n

    def __getitem__(self, idx):
        idx = idx % len(self.render_rgb_files)
        rgb_file = self.render_rgb_files[idx]
        rgb = _imread(rgb_file)[..., :3]
        render_pose = self.render_poses[idx]
        intrinsics = self.render_intrinsics[idx]
        depth_range = self.render_depth_range[idx]

        tsid = self.render_train_set_ids[idx]
        train_rgb_files = self.train_rgb_files[tsid]
        train_poses = self.train_poses[tsid]
        train_intrinsics = self.train_intrinsics[tsid]
        camera = make_camera(*rgb.shape[:2], intrinsics, render_pose)

        if self.mode == "train":
            id_render = (
                train_rgb_files.index(rgb_file) if rgb_file in train_rgb_files else -1
            )
            subsample = self.rng.choice(np.arange(1, 4), p=[0.2, 0.45, 0.35])
            num_select = self.num_source_views + self.rng.randint(low=-2, high=2)
        else:
            id_render = -1
            subsample = 1
            num_select = self.num_source_views

        nearest_ids = get_nearest_pose_ids(
            render_pose, train_poses, min(self.num_source_views * subsample, 28),
            tar_id=id_render, angular_dist_method="dist",
        )
        nearest_ids = self.rng.choice(
            nearest_ids, min(num_select, len(nearest_ids)), replace=False
        )
        assert id_render not in nearest_ids
        if self.mode == "train" and self.rng.choice([0, 1], p=[0.995, 0.005]):
            nearest_ids[self.rng.choice(len(nearest_ids))] = id_render

        src_rgbs, src_cameras = [], []
        for vid in nearest_ids:
            src_rgb = _imread(train_rgb_files[vid])[..., :3]
            src_rgbs.append(src_rgb)
            src_cameras.append(
                make_camera(*src_rgb.shape[:2], train_intrinsics[vid], train_poses[vid])
            )
        src_rgbs = np.stack(src_rgbs, axis=0)
        src_cameras = np.stack(src_cameras, axis=0)

        if self.mode == "train" and self.random_crop_on:
            crop_h = self.rng.randint(low=250, high=750)
            crop_h += crop_h % 2
            crop_w = int(400 * 600 / crop_h)
            crop_w += crop_w % 2
            rgb, camera, src_rgbs, src_cameras = random_crop(
                self.rng, rgb, camera, src_rgbs, src_cameras, (crop_h, crop_w)
            )
        return {
            "rgb": rgb.astype(np.float32),
            "camera": camera,
            "rgb_path": rgb_file,
            "src_rgbs": src_rgbs.astype(np.float32),
            "src_cameras": src_cameras,
            "depth_range": np.array(
                [depth_range[0] * 0.9, depth_range[1] * 1.6], dtype=np.float32
            ),
        }
