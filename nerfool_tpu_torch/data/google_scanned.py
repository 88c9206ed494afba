"""Google Scanned Objects training data (250 renders/object, txt pose +
intrinsics files). Behavioral twin of reference ibrnet/data_loaders/
google_scanned_objects.py:28-122: per-sample random target view, vector-mode
nearest selection, analytic depth range from the pose radius."""
from __future__ import annotations

import glob
import os

import numpy as np

from nerfool_tpu_torch.data.base import Dataset, make_camera
from nerfool_tpu_torch.data.view_selection import get_nearest_pose_ids, rectify_inplane_rotation


def _imread(path):
    import imageio.v2 as imageio

    return imageio.imread(path).astype(np.float32) / 255.0


class GoogleScannedDataset(Dataset):
    def __init__(self, args, mode, seed=234, **kwargs):
        self.folder_path = os.path.join(args.rootdir, "data/google_scanned_objects/")
        self.num_source_views = args.num_source_views
        self.rectify = getattr(args, "rectify_inplane_rotation", False)
        self.rng = np.random.RandomState(seed)

        all_rgb, all_pose, all_intr = [], [], []
        for scene_path in sorted(glob.glob(os.path.join(self.folder_path, "*"))):
            rgb_files = [
                os.path.join(scene_path, "rgb", f)
                for f in sorted(os.listdir(os.path.join(scene_path, "rgb")))
            ]
            pose_files = [f.replace("rgb", "pose").replace("png", "txt") for f in rgb_files]
            intr_files = [
                f.replace("rgb", "intrinsics").replace("png", "txt") for f in rgb_files
            ]
            if min(len(rgb_files), len(pose_files), len(intr_files)) < 250:
                continue
            all_rgb.append(rgb_files)
            all_pose.append(pose_files)
            all_intr.append(intr_files)
        self.all_rgb_files = all_rgb
        self.all_pose_files = all_pose
        self.all_intrinsics_files = all_intr

    def __len__(self):
        return len(self.all_rgb_files)

    def __getitem__(self, idx):
        rgb_files = self.all_rgb_files[idx]
        pose_files = self.all_pose_files[idx]
        intr_files = self.all_intrinsics_files[idx]

        id_render = self.rng.choice(np.arange(len(rgb_files)))
        train_poses = np.stack(
            [np.loadtxt(f).reshape(4, 4) for f in pose_files], axis=0
        )
        render_pose = train_poses[id_render]
        subsample = self.rng.choice(np.arange(1, 6), p=[0.3, 0.25, 0.2, 0.2, 0.05])

        pool = get_nearest_pose_ids(
            render_pose, train_poses, self.num_source_views * subsample,
            tar_id=id_render, angular_dist_method="vector",
        )
        id_feat = self.rng.choice(pool, self.num_source_views, replace=False)
        assert id_render not in id_feat
        if self.rng.choice([0, 1], p=[0.995, 0.005]):
            id_feat[self.rng.choice(len(id_feat))] = id_render

        rgb = _imread(rgb_files[id_render])
        intrinsics = np.loadtxt(intr_files[id_render])
        camera = np.concatenate(
            [np.array(rgb.shape[:2], np.float32), intrinsics.astype(np.float32).reshape(-1),
             render_pose.astype(np.float32).reshape(-1)]
        ).astype(np.float32)

        min_ratio = 0.1
        origin_depth = np.linalg.inv(render_pose)[2, 3]
        max_radius = 0.5 * np.sqrt(2) * 1.1
        near_depth = max(origin_depth - max_radius, min_ratio * origin_depth)
        far_depth = origin_depth + max_radius

        src_rgbs, src_cameras = [], []
        for vid in id_feat:
            src_rgb = _imread(rgb_files[vid])
            pose = np.loadtxt(pose_files[vid])
            if self.rectify:
                pose, src_rgb = rectify_inplane_rotation(
                    pose.reshape(4, 4), render_pose, src_rgb
                )
            src_rgbs.append(src_rgb)
            intr = np.loadtxt(intr_files[vid])
            src_cameras.append(
                np.concatenate(
                    [np.array(src_rgb.shape[:2], np.float32),
                     intr.astype(np.float32).reshape(-1),
                     pose.astype(np.float32).reshape(-1)]
                ).astype(np.float32)
            )
        return {
            "rgb": rgb,
            "camera": camera,
            "rgb_path": rgb_files[id_render],
            "src_rgbs": np.stack(src_rgbs),
            "src_cameras": np.stack(src_cameras),
            "depth_range": np.array([near_depth, far_depth], dtype=np.float32),
        }
