"""COLMAP sparse-model parsers (binary + text).

Standalone readers for COLMAP's cameras/images/points3D files (the format the
LLFF pipeline's poses_bounds.npy was produced from; the reference vendors the
COLMAP-project readers at reference ibrnet/data_loaders/
colmap_read_model.py). Only the fields the framework consumes are kept.
"""
from __future__ import annotations

import collections
import os
import struct

import numpy as np

Camera = collections.namedtuple("Camera", ["id", "model", "width", "height", "params"])
Image = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3d_ids"]
)
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2d_idxs"]
)

# model_id -> (name, num_params)
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def _read(fid, fmt):
    return struct.unpack(fmt, fid.read(struct.calcsize(fmt)))


def read_cameras_binary(path):
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, num_params = _CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * num_params))
            cams[cam_id] = Camera(cam_id, name, width, height, params)
    return cams


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            image_id, qvec, tvec, cam_id = (
                vals[0], np.array(vals[1:5]), np.array(vals[5:8]), vals[8]
            )
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            data = _read(f, "<" + "ddq" * n_pts)
            xys = np.array(data).reshape(-1, 3)[:, :2] if n_pts else np.zeros((0, 2))
            ids = np.array(data[2::3], dtype=np.int64) if n_pts else np.zeros(0, np.int64)
            images[image_id] = Image(
                image_id, qvec, tvec, cam_id, name.decode("utf-8"), xys, ids
            )
    return images


def read_points3d_binary(path):
    pts = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<QdddBBBd")
            pid = vals[0]
            xyz = np.array(vals[1:4])
            rgb = np.array(vals[4:7])
            err = vals[7]
            (track_len,) = _read(f, "<Q")
            track = _read(f, "<" + "ii" * track_len)
            pts[pid] = Point3D(
                pid, xyz, rgb, err,
                np.array(track[0::2]), np.array(track[1::2]),
            )
    return pts


def read_cameras_text(path):
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cams[int(el[0])] = Camera(
                int(el[0]), el[1], int(el[2]), int(el[3]),
                np.array(tuple(map(float, el[4:]))),
            )
    return cams


def read_images_text(path):
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    for head, pts in zip(lines[0::2], lines[1::2]):
        el = head.split()
        image_id = int(el[0])
        qvec = np.array(tuple(map(float, el[1:5])))
        tvec = np.array(tuple(map(float, el[5:8])))
        data = pts.split()
        xys = np.column_stack(
            [tuple(map(float, data[0::3])), tuple(map(float, data[1::3]))]
        ) if data else np.zeros((0, 2))
        ids = np.array(tuple(map(int, data[2::3])), dtype=np.int64) if data else np.zeros(0, np.int64)
        images[image_id] = Image(image_id, qvec, tvec, int(el[8]), el[9], xys, ids)
    return images


def read_model(sparse_dir):
    """Read cameras+images from a COLMAP sparse dir (binary preferred)."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        return (
            read_cameras_binary(os.path.join(sparse_dir, "cameras.bin")),
            read_images_binary(os.path.join(sparse_dir, "images.bin")),
        )
    return (
        read_cameras_text(os.path.join(sparse_dir, "cameras.txt")),
        read_images_text(os.path.join(sparse_dir, "images.txt")),
    )
