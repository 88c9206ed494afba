"""LLFF test-set dataset — the primary eval set.

Behavioral twin of reference ibrnet/data_loaders/llff_test.py:26-209:
every llffhold-th image is a test view, train mode repeats 100000x, the
universal attack's global source set picks views nearest the mean camera
position, source views come from nearest-'dist' selection with random
subsampling in train mode, GT-depth npy plumbing, depth_range = [0.9 near,
1.6 far].
"""
from __future__ import annotations

import os

import numpy as np

from nerfool_tpu_torch.data.base import Dataset, make_camera
from nerfool_tpu_torch.data.llff_utils import batch_parse_llff_poses, load_llff_data
from nerfool_tpu_torch.data.view_selection import (
    get_nearest_pose_ids,
    global_source_ids,
    random_crop,
)


def _imread(path):
    import imageio.v2 as imageio

    return imageio.imread(path).astype(np.float32) / 255.0


class LLFFTestDataset(Dataset):
    def __init__(self, args, mode, scenes=(), use_glb_src=False, seed=234, **kwargs):
        self.folder_path = os.path.join(args.rootdir, "data/nerf_llff_data/")
        self.args = args
        self.mode = mode
        self.num_source_views = args.num_source_views
        self.random_crop_on = getattr(args, "random_crop", False)
        self.use_glb_src = use_glb_src
        self.rng = np.random.RandomState(seed)

        self.render_rgb_files = []
        self.render_intrinsics = []
        self.render_poses = []
        self.render_train_set_ids = []
        self.render_depth_range = []
        self.train_intrinsics = []
        self.train_poses = []
        self.train_rgb_files = []
        self.train_depth_files = []
        self.render_depth_files = []
        self.test_poses = []
        self.render_spiral_poses = None  # spiral path of the last scene

        if isinstance(scenes, str):
            scenes = [scenes]
        if not scenes:
            scenes = sorted(os.listdir(self.folder_path))

        for i, scene in enumerate(scenes):
            scene_path = os.path.join(self.folder_path, scene)
            _, poses, bds, render_poses, i_test, rgb_files = load_llff_data(
                scene_path, load_imgs=False, factor=args.llff_factor
            )
            near_depth, far_depth = float(np.min(bds)), float(np.max(bds))
            intrinsics, c2w_mats = batch_parse_llff_poses(poses)
            self.render_spiral_poses = render_poses

            i_test = np.arange(poses.shape[0])[:: args.llffhold]
            i_train = np.array(
                [j for j in np.arange(poses.shape[0]) if j not in i_test]
            )
            i_render = i_train if mode == "train" else i_test

            self.test_poses.extend(list(c2w_mats[i_test]))
            self.train_intrinsics.append(intrinsics[i_train])
            self.train_poses.append(c2w_mats[i_train])
            self.train_rgb_files.append(np.array(rgb_files)[i_train].tolist())
            n_render = len(i_render)
            self.render_rgb_files.extend(np.array(rgb_files)[i_render].tolist())
            self.render_intrinsics.extend(list(intrinsics[i_render]))
            self.render_poses.extend(list(c2w_mats[i_render]))
            self.render_depth_range.extend([[near_depth, far_depth]] * n_render)
            self.render_train_set_ids.extend([i] * n_render)

            if getattr(args, "gt_depth_path", ""):
                depth_dir = os.path.join(args.gt_depth_path, scene)
                fnames = sorted(
                    f for f in os.listdir(depth_dir) if f.endswith(".npy")
                )
                depth_files = [os.path.join(depth_dir, f) for f in fnames]
                self.train_depth_files.extend(np.array(depth_files)[i_train].tolist())
                self.render_depth_files.extend(np.array(depth_files)[i_render].tolist())

    # spiral path poses for unseen-view interpolation (reference uses
    # train_dataset.render_poses)
    @property
    def render_poses_spiral(self):
        return self.render_spiral_poses

    def target_cameras(self):
        """Every camera vector this dataset can emit (render targets plus
        the train-split source candidates; LLFF images in a scene share
        dimensions) + the union depth range — input for the attack-SPG
        planner (ops/spg.plan_attack_specs)."""
        h, w = _imread(self.render_rgb_files[0]).shape[:2]
        cams = [make_camera(h, w, k, p)
                for k, p in zip(self.render_intrinsics, self.render_poses)]
        for ks, ps in zip(self.train_intrinsics, self.train_poses):
            cams.extend(make_camera(h, w, k, p) for k, p in zip(ks, ps))
        dr = np.asarray(self.render_depth_range, np.float64)
        return np.stack(cams), np.array(
            [dr[:, 0].min(), dr[:, 1].max()], dtype=np.float32)

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

        if self.use_glb_src:
            nearest_ids = global_source_ids(train_poses, num_select)
        else:
            nearest_ids = get_nearest_pose_ids(
                render_pose, train_poses,
                min(self.num_source_views * subsample, 28),
                tar_id=id_render, angular_dist_method="dist",
            )
            nearest_ids = self.rng.choice(
                nearest_ids, min(num_select, len(nearest_ids)), replace=False
            )
        assert id_render not in nearest_ids
        if self.mode == "train" and self.rng.choice([0, 1], p=[0.995, 0.005]):
            nearest_ids[self.rng.choice(len(nearest_ids))] = id_render

        src_rgbs, src_cameras, src_depths = [], [], []
        for vid in nearest_ids:
            src_rgb = _imread(train_rgb_files[vid])[..., :3]
            src_rgbs.append(src_rgb)
            src_cameras.append(
                make_camera(*src_rgb.shape[:2], train_intrinsics[vid], train_poses[vid])
            )
            if self.train_depth_files:
                src_depths.append(np.load(self.train_depth_files[vid]))

        src_rgbs = np.stack(src_rgbs, axis=0)
        src_cameras = np.stack(src_cameras, axis=0)

        data = {
            "rgb": rgb,
            "camera": camera,
            "rgb_path": rgb_file,
            "src_rgbs": src_rgbs,
            "src_cameras": src_cameras,
            "depth_range": np.array(
                [depth_range[0] * 0.9, depth_range[1] * 1.6], dtype=np.float32
            ),
        }
        if self.mode == "train" and self.random_crop_on:
            crop_h = self.rng.randint(low=250, high=750)
            crop_h += crop_h % 2
            crop_w = int(400 * 600 / crop_h)
            crop_w += crop_w % 2
            out = random_crop(
                self.rng, rgb, camera, src_rgbs, src_cameras, (crop_h, crop_w),
                src_depths=np.stack(src_depths) if src_depths else None,
            )
            data["rgb"], data["camera"], data["src_rgbs"], data["src_cameras"] = out[:4]
            if src_depths:
                src_depths = list(out[4])
        if self.render_depth_files:
            data["depth"] = np.load(self.render_depth_files[idx]).astype(np.float32)
        if src_depths:
            data["src_depths"] = np.stack(src_depths, axis=0).astype(np.float32)
        return data
