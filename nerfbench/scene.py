"""The benchmark's scene: a forward-facing rig at the layout of the
``llff_test`` loader, made on the device from the seed.

``n_views`` cameras on a jittered grid in the plane z = 0, all looking down
+z (OpenCV convention, as the port's cameras), with LLFF ``fern``'s
intrinsics at the rig's frame size. Every ``llffhold``-th view is a test view;
each test view's sources are its ``n_src`` nearest train views by camera
distance (the loader's ``angular_dist_method="dist"``), nearest first. The
views see textured layers at several depths in front of a textured back
wall: each layer covers part of the frame through a smooth cut-out, so the
coarse level's weights have structure to resample. What the seed changes:
the layers' depths, extents, textures and colours and the cameras' jitter;
never a size or a count.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def make_camera(h, w, k, c2w):
    """The port's 34-float camera vector: (H, W, K (16), c2w (16))."""
    return np.concatenate([np.array([h, w], np.float32),
                           np.asarray(k, np.float32).reshape(16),
                           np.asarray(c2w, np.float32).reshape(16)])


class Rig:
    """The rig and its images; ``views[i]`` is the port's sample dict of
    test view ``i`` (numpy, as a loader yields it)."""

    def __init__(self, spec, seed, device):
        self.h, self.w = int(spec["h"]), int(spec["w"])
        self.n_views = int(spec["n_views"])
        self.n_src = int(spec["n_src"])
        hold = int(spec["llffhold"])
        near, far = (float(x) for x in spec["depth_range"])
        self.depth_range = np.array([near, far], np.float32)
        self.device = torch.device(device)
        rng = np.random.RandomState(seed % 2 ** 32)

        f = float(spec["focal"]) * self.w / float(spec["focal_width"])
        k = np.eye(4, dtype=np.float32)
        k[0, 0] = k[1, 1] = f
        k[0, 2], k[1, 2] = self.w / 2.0, self.h / 2.0
        self.k = k
        rows, cols = spec["grid"]
        half = np.asarray(spec["baseline"], np.float64) / 2.0
        gy, gx = np.meshgrid(np.linspace(-half[1], half[1], rows),
                             np.linspace(-half[0], half[0], cols),
                             indexing="ij")
        pos = np.stack([gx.ravel(), gy.ravel()], -1)[:self.n_views]
        pos = pos + rng.uniform(-0.15, 0.15, pos.shape) * half / max(rows, cols)
        self.c2w = np.tile(np.eye(4, dtype=np.float32), (self.n_views, 1, 1))
        self.c2w[:, 0, 3], self.c2w[:, 1, 3] = pos[:, 0], pos[:, 1]

        self.i_test = np.arange(self.n_views)[::hold]
        self.i_train = np.array([i for i in range(self.n_views)
                                 if i not in self.i_test])
        self.layers = self._layers(rng, spec["layers"], near, far)
        images = self._render(spec)
        self.images = images.cpu().numpy()
        self.views = [self._sample(i) for i in self.i_test]

    @staticmethod
    def _layers(rng, n_layers, near, far):
        """Depths (in 1/z between 1.4 near and the back wall at 0.7 far),
        extents and texture draws of each layer, the back wall last."""
        inv = np.linspace(1.0 / (1.4 * near), 1.0 / (0.7 * far), n_layers + 1)
        inv[:-1] *= rng.uniform(0.9, 1.1, n_layers)
        out = []
        for i, z in enumerate(1.0 / inv):
            out.append({
                "z": float(z),
                "wall": i == n_layers,
                "centre": rng.uniform(-0.3, 0.3, 2) * z,
                "size": rng.uniform(0.25, 0.5, 2) * z,
                "freq": rng.uniform(2.0, 12.0, (4, 2)) / z,
                "phase": rng.uniform(0.0, 2 * math.pi, 4),
                "colour": rng.uniform(0.1, 0.9, (4, 3)),
                "cut": rng.uniform(1.0, 4.0, 2) / z,
            })
        return out

    def _render(self, spec):
        """[n_views, H, W, 3] float32 images on the device: per pixel the
        nearest layer whose cut-out covers the ray, else the back wall."""
        dev, h, w = self.device, self.h, self.w
        v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                              torch.arange(w, dtype=torch.float32, device=dev),
                              indexing="ij")
        dx = (u - self.k[0, 2]) / self.k[0, 0]
        dy = (v - self.k[1, 2]) / self.k[1, 1]
        out = torch.empty((self.n_views, h, w, 3), device=dev)
        for i in range(self.n_views):
            ox, oy = float(self.c2w[i, 0, 3]), float(self.c2w[i, 1, 3])
            rgb = torch.zeros((h, w, 3), device=dev)
            hit = torch.zeros((h, w), dtype=torch.bool, device=dev)
            for layer in self.layers:  # nearest first
                x = ox + dx * layer["z"]
                y = oy + dy * layer["z"]
                tex = torch.zeros((h, w, 3), device=dev)
                for j in range(4):
                    s = torch.sin(layer["freq"][j, 0] * x
                                  + layer["freq"][j, 1] * y
                                  + layer["phase"][j])
                    tex = tex + (0.5 + 0.5 * s)[..., None] * torch.as_tensor(
                        layer["colour"][j], dtype=torch.float32, device=dev)
                tex = tex / 4.0
                if layer["wall"]:
                    cover = torch.ones_like(hit)
                else:
                    cx, cy = layer["centre"]
                    sx, sy = layer["size"]
                    edge = (1.0 - torch.maximum(torch.abs(x - cx) / sx,
                                                torch.abs(y - cy) / sy)
                            + 0.3 * torch.sin(layer["cut"][0] * x)
                            * torch.cos(layer["cut"][1] * y))
                    cover = edge > 0
                take = cover & ~hit
                rgb = torch.where(take[..., None], tex, rgb)
                hit = hit | cover
            out[i] = rgb.clamp(0.0, 1.0)
        return out

    def sources(self, test_id):
        """The train views nearest test view ``test_id`` by camera
        distance, nearest first."""
        d = np.linalg.norm(self.c2w[self.i_train, :3, 3]
                           - self.c2w[test_id, :3, 3], axis=1)
        return self.i_train[np.argsort(d, kind="stable")[:self.n_src]]

    def camera(self, i):
        return make_camera(self.h, self.w, self.k, self.c2w[i])

    def _sample(self, test_id):
        src = self.sources(test_id)
        return {"rgb": self.images[test_id],
                "camera": self.camera(test_id),
                "rgb_path": f"rig_{test_id:03d}.png",
                "src_rgbs": self.images[src],
                "src_cameras": np.stack([self.camera(i) for i in src]),
                "depth_range": self.depth_range.copy()}
