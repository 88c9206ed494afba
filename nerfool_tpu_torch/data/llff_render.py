"""Spiral-path render dataset for video rendering (no GT rgb per frame).

Behavioral twin of reference gnt/data_loaders/llff_render.py:13-110:
120 spiral render poses per scene, nearest-'dist' source selection from the
train split, depth_range = [0.9 near, 1.5 far].
"""
from __future__ import annotations

import os

import numpy as np

from nerfool_tpu_torch.data.base import Dataset, make_camera
from nerfool_tpu_torch.data.llff_utils import (batch_parse_llff_poses, imread,
                                                load_llff_data)
from nerfool_tpu_torch.data.view_selection import get_nearest_pose_ids


def _imread(path):
    return imread(path).astype(np.float32) / 255.0


class LLFFRenderDataset(Dataset):
    def __init__(self, args, mode="render", scenes="fern", **kwargs):
        self.folder_path = os.path.join(args.rootdir, "data/nerf_llff_data/")
        self.num_source_views = args.num_source_views
        if isinstance(scenes, str):
            scenes = [scenes]

        self.render_intrinsics, self.render_poses = [], []
        self.render_depth_range, self.render_train_set_ids = [], []
        self.h, self.w = [], []
        self.train_intrinsics, self.train_poses, self.train_rgb_files = [], [], []

        for i, scene in enumerate(scenes):
            scene_path = os.path.join(self.folder_path, scene)
            _, poses, bds, render_poses, i_test, rgb_files = load_llff_data(
                scene_path, load_imgs=False, factor=getattr(args, "llff_factor", 4)
            )
            near_depth, far_depth = float(np.min(bds)), float(np.max(bds))
            intrinsics, c2w_mats = batch_parse_llff_poses(poses)
            h, w = poses[0][:2, -1]
            render_intr, render_c2w = batch_parse_llff_poses(render_poses)

            i_train = np.array(
                [j for j in np.arange(len(rgb_files)) if j != i_test]
            )
            self.train_intrinsics.append(intrinsics[i_train])
            self.train_poses.append(c2w_mats[i_train])
            self.train_rgb_files.append(np.array(rgb_files)[i_train].tolist())
            n = len(render_intr)
            self.render_intrinsics.extend(list(render_intr))
            self.render_poses.extend(list(render_c2w))
            self.render_depth_range.extend([[near_depth, far_depth]] * n)
            self.render_train_set_ids.extend([i] * n)
            self.h.extend([int(h)] * n)
            self.w.extend([int(w)] * n)

    def __len__(self):
        return len(self.render_poses)

    def __getitem__(self, idx):
        render_pose = self.render_poses[idx]
        intrinsics = self.render_intrinsics[idx]
        depth_range = self.render_depth_range[idx]
        tsid = self.render_train_set_ids[idx]
        train_rgb_files = self.train_rgb_files[tsid]
        train_poses = self.train_poses[tsid]
        train_intrinsics = self.train_intrinsics[tsid]

        camera = make_camera(self.h[idx], self.w[idx], intrinsics, render_pose)
        nearest_ids = get_nearest_pose_ids(
            render_pose, train_poses, self.num_source_views, tar_id=-1,
            angular_dist_method="dist",
        )
        src_rgbs, src_cameras = [], []
        for vid in nearest_ids:
            src_rgb = _imread(train_rgb_files[vid])
            src_rgbs.append(src_rgb)
            src_cameras.append(
                make_camera(*src_rgb.shape[:2], train_intrinsics[vid], train_poses[vid])
            )
        return {
            "camera": camera,
            "rgb_path": "",
            "src_rgbs": np.stack(src_rgbs)[..., :3].astype(np.float32),
            "src_cameras": np.stack(src_cameras),
            "depth_range": np.array(
                [depth_range[0] * 0.9, depth_range[1] * 1.5], dtype=np.float32
            ),
        }
