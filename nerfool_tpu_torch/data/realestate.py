"""RealEstate10K-subset training data (video-frame sequences with per-frame
pose txt files). Behavioral twin of reference ibrnet/data_loaders/
realestate.py:25-151: window-based temporal source selection, 450x800 resize,
normalized intrinsics unnormalized by the target size, depth range [1, 100]."""
from __future__ import annotations

import glob
import os

import numpy as np

from nerfool_tpu_torch.data.base import Dataset


class Camera:
    def __init__(self, entry):
        fx, fy, cx, cy = entry[1:5]
        self.intrinsics = np.array(
            [[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0], [0, 0, 0, 1]]
        )
        w2c = np.eye(4)
        w2c[:3, :] = np.array(entry[7:]).reshape(3, 4)
        self.w2c_mat = w2c
        self.c2w_mat = np.linalg.inv(w2c)


def unnormalize_intrinsics(intrinsics, h, w):
    intrinsics = intrinsics.copy()
    intrinsics[0] *= w
    intrinsics[1] *= h
    return intrinsics


def parse_pose_file(file):
    cam_params = {}
    with open(file) as f:
        for i, line in enumerate(f):
            if i == 0:
                continue
            entry = [float(x) for x in line.split()]
            cam_params[int(entry[0])] = Camera(entry)
    return cam_params


class RealEstateDataset(Dataset):
    def __init__(self, args, mode, seed=234, **kwargs):
        self.folder_path = os.path.join(args.rootdir, "data/RealEstate10K-subset/")
        self.mode = mode
        self.num_source_views = args.num_source_views
        self.target_h, self.target_w = 450, 800
        assert mode in ("train", "test")
        self.rng = np.random.RandomState(seed)

        self.all_rgb_files, self.all_timestamps = [], []
        for scene_path in sorted(
            glob.glob(os.path.join(self.folder_path, mode, "frames", "*"))
        ):
            rgb_files = [
                os.path.join(scene_path, f) for f in sorted(os.listdir(scene_path))
            ]
            if len(rgb_files) < 10:
                continue
            ts = [int(os.path.basename(f).split(".")[0]) for f in rgb_files]
            order = np.argsort(ts)
            self.all_rgb_files.append(np.array(rgb_files)[order])
            self.all_timestamps.append(np.array(ts)[order])

    def __len__(self):
        return len(self.all_rgb_files)

    def _read_resized(self, path):
        import cv2
        import imageio.v2 as imageio

        img = imageio.imread(path)
        img = cv2.resize(
            img, dsize=(self.target_w, self.target_h), interpolation=cv2.INTER_AREA
        )
        return img.astype(np.float32) / 255.0

    def __getitem__(self, idx):
        rgb_files = self.all_rgb_files[idx]
        timestamps = self.all_timestamps[idx]
        num_frames = len(rgb_files)
        window_size = 32
        shift = self.rng.randint(low=-1, high=2)
        id_render = self.rng.randint(low=4, high=num_frames - 5)

        right = min(id_render + window_size + shift, num_frames - 1)
        left = max(0, right - 2 * window_size)
        candidates = np.arange(left, right)
        if self.rng.choice([0, 1], p=[0.01, 0.99]):
            candidates = candidates[candidates != id_render]
        id_feat = self.rng.choice(
            candidates, size=min(self.num_source_views, len(candidates)), replace=False
        )

        rgb_file = rgb_files[id_render]
        rgb = self._read_resized(rgb_file)
        camera_file = os.path.dirname(rgb_file).replace("frames", "cameras") + ".txt"
        cam_params = parse_pose_file(camera_file)
        cam = cam_params[timestamps[id_render]]
        camera = np.concatenate(
            [np.array(rgb.shape[:2], np.float32),
             unnormalize_intrinsics(cam.intrinsics, self.target_h, self.target_w).reshape(-1),
             cam.c2w_mat.reshape(-1)]
        ).astype(np.float32)

        src_rgbs, src_cameras = [], []
        for vid in id_feat:
            src_rgb = self._read_resized(rgb_files[vid])
            src_rgbs.append(src_rgb)
            c = cam_params[timestamps[vid]]
            src_cameras.append(
                np.concatenate(
                    [np.array(src_rgb.shape[:2], np.float32),
                     unnormalize_intrinsics(
                         c.intrinsics, self.target_h, self.target_w
                     ).reshape(-1),
                     c.c2w_mat.reshape(-1)]
                ).astype(np.float32)
            )
        return {
            "rgb": rgb,
            "camera": camera,
            "rgb_path": rgb_file,
            "src_rgbs": np.stack(src_rgbs),
            "src_cameras": np.stack(src_cameras),
            "depth_range": np.array([1.0, 100.0], dtype=np.float32),
        }
