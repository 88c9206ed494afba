"""LLFF training dataset over real_iconic_noface (reference
reference ibrnet/data_loaders/llff.py:26-143). Train mode uses every
view; eval holds out every llffhold-th view."""
from __future__ import annotations

import os

import numpy as np

from nerfool_tpu_torch.data.base import Dataset, make_camera
from nerfool_tpu_torch.data.llff_utils import batch_parse_llff_poses, load_llff_data
from nerfool_tpu_torch.data.view_selection import get_nearest_pose_ids, random_crop


def _imread(path):
    import imageio.v2 as imageio

    return imageio.imread(path).astype(np.float32) / 255.0


class LLFFDataset(Dataset):
    def __init__(self, args, mode, scenes=(), seed=234, **kwargs):
        base_dir = os.path.join(args.rootdir, "data/real_iconic_noface/")
        self.args = args
        self.mode = mode
        self.num_source_views = args.num_source_views
        self.random_crop_on = getattr(args, "random_crop", False)
        self.rng = np.random.RandomState(seed)

        self.render_rgb_files, self.render_intrinsics = [], []
        self.render_poses, self.render_train_set_ids = [], []
        self.render_depth_range = []
        self.train_intrinsics, self.train_poses, self.train_rgb_files = [], [], []

        scenes = scenes or sorted(os.listdir(base_dir))
        if isinstance(scenes, str):
            scenes = [scenes]
        for i, scene in enumerate(scenes):
            scene_path = os.path.join(base_dir, scene)
            _, poses, bds, _, _, rgb_files = load_llff_data(
                scene_path, load_imgs=False, factor=4
            )
            near_depth, far_depth = float(np.min(bds)), float(np.max(bds))
            intrinsics, c2w_mats = batch_parse_llff_poses(poses)
            if mode == "train":
                i_train = np.arange(poses.shape[0])
                i_render = i_train
            else:
                i_test = np.arange(poses.shape[0])[:: args.llffhold]
                i_train = np.array(
                    [j for j in np.arange(poses.shape[0]) if j not in i_test]
                )
                i_render = i_test
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
        return len(self.render_rgb_files)

    def __getitem__(self, idx):
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
            id_render = train_rgb_files.index(rgb_file)
            subsample = self.rng.choice(np.arange(1, 4), p=[0.2, 0.45, 0.35])
            num_select = self.num_source_views + self.rng.randint(low=-2, high=3)
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
