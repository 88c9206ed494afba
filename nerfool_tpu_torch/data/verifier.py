"""Epipolar-geometry data sanity checker.

Equivalent of the reference's manual visual tool
(reference ibrnet/data_loaders/data_verifier.py): computes the
fundamental matrix between two camera vectors and (optionally) draws epipolar
lines for corresponding points; also exposes a numeric consistency check so it
can run in CI instead of being eyeballed.
"""
from __future__ import annotations

import numpy as np


def skew(x):
    return np.array([[0, -x[2], x[1]], [x[2], 0, -x[0]], [-x[1], x[0], 0]])


def two_view_geometry(intrinsics1, extrinsics1, intrinsics2, extrinsics2):
    """Fundamental matrix mapping view-1 pixels to view-2 epipolar lines.

    extrinsics are world-to-camera here (the reference passes inverted c2w).
    """
    relative_pose = extrinsics2.dot(np.linalg.inv(extrinsics1))
    r = relative_pose[:3, :3]
    t = relative_pose[:3, 3]
    e = skew(t).dot(r)
    return np.linalg.inv(intrinsics2[:3, :3]).T.dot(e).dot(
        np.linalg.inv(intrinsics1[:3, :3])
    )


def fundamental_from_cameras(camera1, camera2):
    """34-vector cameras -> fundamental matrix."""
    k1 = camera1[2:18].reshape(4, 4)
    k2 = camera2[2:18].reshape(4, 4)
    w2c1 = np.linalg.inv(camera1[18:34].reshape(4, 4))
    w2c2 = np.linalg.inv(camera2[18:34].reshape(4, 4))
    return two_view_geometry(k1, w2c1, k2, w2c2)


def epipolar_consistency(camera1, camera2, pts3d):
    """Max |x2^T F x1| residual for 3D points projected into both cameras —
    ~0 for consistent cameras."""
    f = fundamental_from_cameras(camera1, camera2)

    def project(cam, pts):
        k = cam[2:18].reshape(4, 4)[:3, :3]
        w2c = np.linalg.inv(cam[18:34].reshape(4, 4))
        p = (w2c[:3, :3] @ pts.T + w2c[:3, 3:4])
        p = k @ p
        return (p[:2] / p[2:3]).T

    x1 = project(camera1, pts3d)
    x2 = project(camera2, pts3d)
    x1h = np.concatenate([x1, np.ones((len(x1), 1))], -1)
    x2h = np.concatenate([x2, np.ones((len(x2), 1))], -1)
    lines = x1h @ f.T  # epipolar lines in view 2
    lines = lines / (np.linalg.norm(lines[:, :2], axis=1, keepdims=True) + 1e-12)
    return float(np.max(np.abs(np.sum(x2h * lines, axis=1))))


def draw_epipolar_lines(camera1, camera2, img1, img2, n_points=8, seed=0):
    """Visual check: random points in view 1 and their epipolar lines in view 2.
    Returns the two annotated images (uint8)."""
    import cv2

    rng = np.random.RandomState(seed)
    h, w = img1.shape[:2]
    f = fundamental_from_cameras(camera1, camera2)
    pts = np.stack(
        [rng.randint(w // 8, 7 * w // 8, n_points),
         rng.randint(h // 8, 7 * h // 8, n_points)], -1
    ).astype(np.float64)
    img1 = (img1 * 255).astype(np.uint8).copy()
    img2 = (img2 * 255).astype(np.uint8).copy()
    for i, p in enumerate(pts):
        color = tuple(int(c) for c in rng.randint(0, 255, 3))
        cv2.circle(img1, tuple(p.astype(int)), 4, color, -1)
        a, b, c = f @ np.array([p[0], p[1], 1.0])
        if abs(b) > 1e-9:
            x0, y0 = 0, int(-c / b)
            x1, y1 = w, int(-(c + a * w) / b)
            cv2.line(img2, (x0, y0), (x1, y1), color, 1)
    return img1, img2


def verify_data(data, n_pairs=3, tol=1e-3):
    """Numeric sanity check of a canonical sample dict: source cameras must be
    pairwise epipolar-consistent on synthetic 3D points within the depth range."""
    rng = np.random.RandomState(0)
    near, far = np.asarray(data["depth_range"]).reshape(-1)[:2]
    pts = rng.randn(32, 3) * 0.5
    cams = np.asarray(data["src_cameras"]).reshape(-1, 34)
    residuals = []
    for _ in range(n_pairs):
        i, j = rng.choice(len(cams), 2, replace=False)
        residuals.append(epipolar_consistency(cams[i], cams[j], pts))
    return max(residuals) < tol, max(residuals)
