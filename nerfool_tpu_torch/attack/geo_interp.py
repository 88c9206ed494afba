"""Camera-pose interpolation for unseen-view attack targets (the port's own
copy of ``nerfool_tpu/attack/geo_interp.py``).

Host-side numpy, run once per attack iteration: slerp-based ``interp`` /
``interp3`` of c2w poses, with decoupled rotation and translation amounts,
and no scipy dependency (the quaternion conversion is inlined).
"""
from __future__ import annotations

import numpy as np


def _mat_to_quat(m):
    """Rotation matrix -> quaternion (x, y, z, w), scipy convention."""
    t = np.trace(m)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        w = 0.25 / s
        x = (m[2, 1] - m[1, 2]) * s
        y = (m[0, 2] - m[2, 0]) * s
        z = (m[1, 0] - m[0, 1]) * s
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12))
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (m[k, j] - m[j, k]) / s
        q[j] = (m[j, i] + m[i, j]) / s
        q[k] = (m[k, i] + m[i, k]) / s
        x, y, z, w = q
    return np.array([x, y, z, w], dtype=np.float64)


def _quat_to_mat(q):
    x, y, z, w = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def slerp(p0, p1, t):
    """Spherical interpolation of quaternions."""
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    omega = np.arccos(
        np.clip(np.dot(p0 / np.linalg.norm(p0), p1 / np.linalg.norm(p1)), -1.0, 1.0)
    )
    so = np.sin(omega)
    if abs(so) < 1e-10:
        return (1.0 - t) * p0 + t * p1
    return np.sin((1.0 - t) * omega) / so * p0 + np.sin(t * omega) / so * p1


def interp(pose1, pose2, s):
    """Interpolate two c2w 4x4 poses; ``s`` may be a scalar or [s_rot, s_trans]."""
    pose1 = np.asarray(pose1, dtype=np.float64)
    pose2 = np.asarray(pose2, dtype=np.float64)
    if isinstance(s, (list, tuple)):
        s_rot, s_trans = s
    else:
        s_rot = s_trans = s
    c = (1 - s_trans) * pose1[:3, 3] + s_trans * pose2[:3, 3]
    q = slerp(_mat_to_quat(pose1[:3, :3]), _mat_to_quat(pose2[:3, :3]), s_rot)
    out = np.eye(4)
    out[:3, :3] = _quat_to_mat(q)
    out[:3, 3] = c
    return out.astype(np.float32)


def interp3(pose1, pose2, pose3, s12, s3):
    return interp(interp(pose1, pose2, s12), pose3, s3)


def sample_unseen_pose(rng, render_poses, interp_upbound=1.0,
                       decouple=False, upbound_rot=1.0, upbound_trans=1.0,
                       sample_based_on_depth=False, beta=0.5, temp=0.5):
    """Sample an interpolated unseen camera pose from the spiral render
    poses: three distinct poses and two interpolation amounts drawn from
    ``rng`` (a ``numpy.random.RandomState``)."""
    poses = np.asarray(render_poses)
    if sample_based_on_depth:
        z = poses[:, 2, 2]
        p = np.exp(z / temp) / np.sum(np.exp(z / temp))
        ids = rng.choice(len(poses), size=3, p=p, replace=False)
    else:
        ids = rng.choice(len(poses), size=3, replace=False)
    if decouple:
        s12_r, s3_r = rng.uniform(0, upbound_rot, size=2)
        s12_t, s3_t = rng.uniform(0, upbound_trans, size=2)
        s12, s3 = [s12_r, s12_t], [s3_r, s3_t]
    elif sample_based_on_depth:
        s12, s3 = rng.beta(beta, beta, size=2) * upbound_rot
    else:
        s12, s3 = rng.uniform(0, interp_upbound, size=2)
    return interp3(poses[ids[0]], poses[ids[1]], poses[ids[2]], s12, s3)
