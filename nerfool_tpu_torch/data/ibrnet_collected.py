"""IBRNet-collected training data (collected_1 at factor 2, collected_2 at
factor 8). Behavioral twin of reference ibrnet/data_loaders/
ibrnet_collected.py:27-152: world-center-aware nearest-view selection, random
crop + random horizontal flip augmentation."""
from __future__ import annotations

import glob
import os

import numpy as np

from nerfool_tpu_torch.data.base import Dataset, make_camera
from nerfool_tpu_torch.data.llff_utils import batch_parse_llff_poses, load_llff_data
from nerfool_tpu_torch.data.view_selection import (
    get_nearest_pose_ids,
    random_crop,
    random_flip,
    rectify_inplane_rotation,
)


def _imread(path):
    import imageio.v2 as imageio

    return imageio.imread(path).astype(np.float32) / 255.0


class IBRNetCollectedDataset(Dataset):
    def __init__(self, args, mode, random_crop=True, seed=234, **kwargs):
        folder1 = os.path.join(args.rootdir, "data/ibrnet_collected_1/")
        folder2 = os.path.join(args.rootdir, "data/ibrnet_collected_2/")
        self.rectify = getattr(args, "rectify_inplane_rotation", False)
        self.mode = mode
        self.num_source_views = args.num_source_views
        self.random_crop_on = random_crop
        self.rng = np.random.RandomState(seed)

        all_scenes = sorted(glob.glob(folder1 + "*")) + sorted(glob.glob(folder2 + "*"))
        self.render_rgb_files, self.render_intrinsics = [], []
        self.render_poses, self.render_train_set_ids = [], []
        self.render_depth_range = []
        self.train_intrinsics, self.train_poses, self.train_rgb_files = [], [], []

        for i, scene in enumerate(all_scenes):
            factor = 8 if "ibrnet_collected_2" in scene else 2
            _, poses, bds, _, _, rgb_files = load_llff_data(
                scene, load_imgs=False, factor=factor
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
        mean_depth = np.mean(depth_range)
        world_center = (render_pose @ np.array([0, 0, mean_depth, 1.0]))[:3]

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
            render_pose, train_poses, min(self.num_source_views * subsample, 22),
            tar_id=id_render, angular_dist_method="dist", scene_center=world_center,
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
            pose = train_poses[vid]
            if self.rectify:
                pose, src_rgb = rectify_inplane_rotation(pose, render_pose, src_rgb)
            src_rgbs.append(src_rgb)
            src_cameras.append(
                make_camera(*src_rgb.shape[:2], train_intrinsics[vid], pose)
            )
        src_rgbs = np.stack(src_rgbs, axis=0)
        src_cameras = np.stack(src_cameras, axis=0)

        if self.mode == "train" and self.random_crop_on:
            rgb, camera, src_rgbs, src_cameras = random_crop(
                self.rng, rgb, camera, src_rgbs, src_cameras
            )
        if self.mode == "train" and self.rng.choice([0, 1], p=[0.5, 0.5]):
            rgb, camera, src_rgbs, src_cameras = random_flip(
                rgb, camera, src_rgbs, src_cameras
            )
        return {
            "rgb": rgb.astype(np.float32),
            "camera": camera,
            "rgb_path": rgb_file,
            "src_rgbs": src_rgbs.astype(np.float32),
            "src_cameras": src_cameras,
            "depth_range": np.array(
                [depth_range[0] * 0.9, depth_range[1] * 1.5], dtype=np.float32
            ),
        }
