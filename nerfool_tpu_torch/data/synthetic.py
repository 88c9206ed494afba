"""Procedural synthetic dataset: orbit cameras around textured planes.

No counterpart in the reference — this fixture exercises every loader-dependent
code path (renderer, attack, eval, video) without dataset downloads, and powers
CI and benchmarks. Produces the canonical sample dict, optionally with exact
GT depth (the geometry is analytic).
"""
from __future__ import annotations

import numpy as np

from nerfool_tpu_torch.data.base import Dataset, make_camera
from nerfool_tpu_torch.data.view_selection import get_nearest_pose_ids, global_source_ids


def _look_at(eye, target, up=np.array([0.0, -1.0, 0.0])):
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w


class SyntheticDataset(Dataset):
    """Checkerboard plane at z=0 viewed from an orbit arc."""

    def __init__(self, args=None, mode="test", scenes=(), use_glb_src=False,
                 n_views=12, h=48, w=64, seed=0, with_depth=True, **kwargs):
        self.mode = mode
        self.h, self.w = h, w
        self.use_glb_src = use_glb_src
        self.num_source_views = getattr(args, "num_source_views", 4) if args else 4
        self.rng = np.random.RandomState(seed)
        self.with_depth = with_depth

        radius = 4.0
        self.poses = []
        for i in range(n_views):
            theta = (i / n_views - 0.5) * np.pi * 0.6
            eye = np.array(
                [radius * np.sin(theta), 1.2, -radius * np.cos(theta)], dtype=np.float32
            )
            self.poses.append(_look_at(eye, np.zeros(3)))
        self.poses = np.stack(self.poses)
        k = np.eye(4, dtype=np.float32)
        k[0, 0] = k[1, 1] = 0.9 * w
        k[0, 2], k[1, 2] = w / 2.0, h / 2.0
        self.intrinsics = k

        hold = 4
        i_test = np.arange(n_views)[::hold]
        i_train = np.array([j for j in range(n_views) if j not in i_test])
        self.i_render = i_train if mode == "train" else i_test
        self.i_train = i_train
        self.render_poses = self.poses[i_train]  # stands in for the spiral path

        self.images, self.depths = zip(*[self._render_gt(p) for p in self.poses])
        self.images = np.stack(self.images)
        self.depths = np.stack(self.depths)

    def _render_gt(self, c2w):
        """Analytic render: checkerboard plane z=0 + background gradient."""
        h, w = self.h, self.w
        u, v = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        pix = np.stack([u.reshape(-1), v.reshape(-1), np.ones(h * w, np.float32)])
        dirs = (c2w[:3, :3] @ (np.linalg.inv(self.intrinsics[:3, :3]) @ pix)).T
        origin = c2w[:3, 3]
        t = -origin[2] / np.where(np.abs(dirs[:, 2]) < 1e-6, 1e-6, dirs[:, 2])
        pts = origin[None] + t[:, None] * dirs
        hit = (t > 0) & (np.abs(pts[:, 0]) < 3) & (np.abs(pts[:, 1]) < 3)
        checker = ((np.floor(pts[:, 0] * 2) + np.floor(pts[:, 1] * 2)) % 2).astype(np.float32)
        base = np.stack(
            [0.2 + 0.6 * checker, 0.3 + 0.4 * (1 - checker),
             0.5 + 0.3 * np.sin(pts[:, 0])], axis=-1
        )
        bg = np.stack([0.9 * np.ones_like(t), 0.95 * np.ones_like(t), np.ones_like(t)], -1)
        rgb = np.where(hit[:, None], base, bg).reshape(h, w, 3)
        depth_hit = t * np.linalg.norm(dirs, axis=-1) / np.linalg.norm(dirs, axis=-1)
        depth = np.where(hit, t, 8.0).reshape(h, w)
        return np.clip(rgb, 0, 1).astype(np.float32), depth.astype(np.float32)

    def target_cameras(self):
        """Every camera vector this dataset can emit (targets AND source
        candidates share the pose set) + the union depth range — input for
        the attack-SPG planner (ops/spg.plan_attack_specs)."""
        cams = np.stack([
            make_camera(self.h, self.w, self.intrinsics, p) for p in self.poses
        ])
        return cams, np.array([2.0, 8.0], dtype=np.float32)

    def __len__(self):
        n = len(self.i_render)
        return n * 100000 if self.mode == "train" else n

    def __getitem__(self, idx):
        idx = self.i_render[idx % len(self.i_render)]
        render_pose = self.poses[idx]
        camera = make_camera(self.h, self.w, self.intrinsics, render_pose)
        if self.use_glb_src:
            nearest = global_source_ids(self.poses[self.i_train], self.num_source_views)
        else:
            tar_in_train = np.where(self.i_train == idx)[0]
            nearest = get_nearest_pose_ids(
                render_pose, self.poses[self.i_train], self.num_source_views,
                tar_id=int(tar_in_train[0]) if len(tar_in_train) else -1,
                angular_dist_method="dist",
            )
        src_ids = self.i_train[nearest]
        data = {
            "rgb": self.images[idx],
            "camera": camera,
            "rgb_path": f"synthetic_{idx:03d}.png",
            "src_rgbs": self.images[src_ids],
            "src_cameras": np.stack(
                [make_camera(self.h, self.w, self.intrinsics, self.poses[i]) for i in src_ids]
            ),
            "depth_range": np.array([2.0, 8.0], dtype=np.float32),
        }
        if self.with_depth:
            data["depth"] = self.depths[idx]
            data["src_depths"] = self.depths[src_ids]
        return data
