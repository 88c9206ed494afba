"""DeepVoxels dataset (txt pose/intrinsics files).

Behavioral twin of reference ibrnet/data_loaders/deepvoxels.py:26-153:
per-scene txt intrinsics rescaled to the 512 render size, testskip on non-train
subsets, per-view depth range centered at the camera origin's z in world space
(cube special-cased), vector-mode nearest-view selection.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from nerfool_tpu_torch.data.base import Dataset, make_camera
from nerfool_tpu_torch.data.view_selection import (
    get_nearest_pose_ids,
    global_source_ids,
    rectify_inplane_rotation,
)


def _imread(path):
    import imageio.v2 as imageio

    return imageio.imread(path).astype(np.float32) / 255.0


def parse_intrinsics(filepath, trgt_sidelength, invert_y=False):
    """DeepVoxels intrinsics.txt -> (intrinsics [4,4], barycenter, scale,
    near_plane, world2cam) rescaled to the target side length
    (reference data_utils.py:182-217)."""
    with open(filepath) as f:
        fl, cx, cy = list(map(float, f.readline().split()))[:3]
        barycenter = np.array(list(map(float, f.readline().split())))
        near_plane = float(f.readline())
        scale = float(f.readline())
        height, width = map(float, f.readline().split())
        try:
            world2cam = bool(int(f.readline()))
        except (ValueError, EOFError):
            world2cam = False
    cx = cx / width * trgt_sidelength
    cy = cy / height * trgt_sidelength
    fl = trgt_sidelength / height * fl
    fy = -fl if invert_y else fl
    intr = np.array(
        [[fl, 0.0, cx, 0.0], [0.0, fy, cy, 0], [0.0, 0, 1, 0], [0, 0, 0, 1]]
    )
    return intr, barycenter, scale, near_plane, world2cam


class DeepVoxelsDataset(Dataset):
    def __init__(self, args, mode, scenes="vase", use_glb_src=False, seed=234, **kwargs):
        self.folder_path = os.path.join(args.rootdir, "data/deepvoxels/")
        self.rectify = getattr(args, "rectify_inplane_rotation", False)
        self.subset = mode
        self.num_source_views = args.num_source_views
        self.testskip = args.testskip
        self.use_glb_src = use_glb_src
        self.rng = np.random.RandomState(seed)

        if isinstance(scenes, str):
            scenes = [scenes]
        self.all_rgb_files, self.all_pose_files, self.all_intrinsics_files = [], [], []
        for scene in scenes:
            self.scene_path = os.path.join(self.folder_path, mode, scene)
            rgb_files = [
                os.path.join(self.scene_path, "rgb", f)
                for f in sorted(os.listdir(os.path.join(self.scene_path, "rgb")))
            ]
            limit = getattr(args, "total_view_limit", None)
            if limit is not None:
                rgb_files = rgb_files[:limit]
            if mode != "train":
                rgb_files = rgb_files[:: self.testskip]
            pose_files = [
                f.replace("rgb", "pose").replace("png", "txt") for f in rgb_files
            ]
            intr_file = os.path.join(self.scene_path, "intrinsics.txt")
            self.all_rgb_files.extend(rgb_files)
            self.all_pose_files.extend(pose_files)
            self.all_intrinsics_files.extend([intr_file] * len(rgb_files))

    def __len__(self):
        return len(self.all_rgb_files)

    def __getitem__(self, idx):
        idx = idx % len(self.all_rgb_files)
        rgb_file = self.all_rgb_files[idx]
        pose_file = self.all_pose_files[idx]
        intrinsics = parse_intrinsics(self.all_intrinsics_files[idx], 512)[0]

        train_rgb_files = sorted(
            glob.glob(os.path.join(
                self.scene_path.replace(f"/{self.subset}/", "/train/"), "rgb", "*"
            ))
        )
        train_pose_files = [
            f.replace("rgb", "pose").replace("png", "txt") for f in train_rgb_files
        ]
        train_poses = np.stack(
            [np.loadtxt(f).reshape(4, 4) for f in train_pose_files], axis=0
        )

        if self.subset == "train":
            id_render = train_pose_files.index(pose_file)
            subsample = self.rng.choice(np.arange(1, 5))
            num_select = self.rng.randint(
                low=self.num_source_views - 4, high=self.num_source_views + 2
            )
        else:
            id_render = -1
            subsample = 1
            num_select = self.num_source_views

        rgb = _imread(rgb_file)
        render_pose = np.loadtxt(pose_file).reshape(4, 4)
        camera = make_camera(*rgb.shape[:2], intrinsics, render_pose)

        if self.use_glb_src:
            nearest_ids = global_source_ids(train_poses, num_select)
        else:
            nearest_ids = get_nearest_pose_ids(
                render_pose, train_poses, min(num_select * subsample, 40),
                tar_id=id_render, angular_dist_method="vector",
            )
            nearest_ids = self.rng.choice(nearest_ids, num_select, replace=False)
        assert id_render not in nearest_ids
        if self.subset == "train" and self.rng.choice([0, 1], p=[0.995, 0.005]):
            nearest_ids[self.rng.choice(len(nearest_ids))] = id_render

        src_rgbs, src_cameras = [], []
        for vid in nearest_ids:
            src_rgb = _imread(train_rgb_files[vid])
            pose = train_poses[vid]
            if self.rectify:
                pose, src_rgb = rectify_inplane_rotation(pose, render_pose, src_rgb)
            src_rgbs.append(src_rgb)
            src_cameras.append(make_camera(*src_rgb.shape[:2], intrinsics, pose))

        origin_depth = np.linalg.inv(render_pose)[2, 3]
        half = 1.0 if "cube" in rgb_file else 0.8
        return {
            "rgb": rgb[..., :3].astype(np.float32),
            "camera": camera,
            "rgb_path": rgb_file,
            "src_rgbs": np.stack(src_rgbs)[..., :3].astype(np.float32),
            "src_cameras": np.stack(src_cameras),
            "depth_range": np.array(
                [origin_depth - half, origin_depth + half], dtype=np.float32
            ),
            "scene_path": self.scene_path,
        }
