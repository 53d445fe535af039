"""Rotation algebra: Euler (roll, pitch, yaw) -> 3x3 matrices.

The reference builds rotations from Imath quaternions with Euler order
ZXY (envutil_payload.cc:136-218, ``rotate_3d`` / ``make_r3_t``): roll is
a rotation about FORWARD (z), pitch about RIGHT (x), yaw about DOWN (y),
applied in the order roll, then pitch, then yaw:

    R(roll, pitch, yaw) = Ry(yaw) @ Rx(pitch) @ Rz(roll)

(verified bit-for-bit against Imath in tests/data/imath_rotation_truth.json,
see tests/test_rotation.py).

We represent rotations as standard numpy float64 3x3 matrices acting on
column vectors: ``v' = R @ v``. The reference's r3_t holds the *rotated
basis vectors* as rows and applies them via ``rotate(v, m) = sum v_i m[i]``
(geometry.h:74-109), which equals ``R @ v`` with our ``R``; concatenation
``rotate(lhs, rhs)`` equals ``R_rhs @ R_lhs``. These matrices are built
host-side in float64 and baked into jitted code as constants.
"""

from __future__ import annotations

import numpy as np


def _rx(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def _ry(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def _rz(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def rotation_rpy(roll: float, pitch: float, yaw: float,
                 inverse: bool = False) -> np.ndarray:
    """Rotation matrix for Euler angles in radians, Imath ZXY semantics
    (reference make_r3_t, envutil_payload.cc:210-218)."""
    r = _ry(yaw) @ _rx(pitch) @ _rz(roll)
    return r.T.copy() if inverse else r


def camera_to_facet(cam_rpy: tuple, facet_rpy: tuple) -> np.ndarray:
    """Combined rotation taking rays from the virtual camera's (target)
    coordinate system to a facet's coordinate system:

        R = R(facet)^T @ R(camera)

    This is the reference's ``rotate(r_camera, r_facet)`` with
    r_camera = make_r3_t(roll, pitch, yaw, false) and
    r_facet = make_r3_t(f.roll, f.pitch, f.yaw, true)
    (envutil_payload.cc:1921-1948)."""
    r_cam = rotation_rpy(*cam_rpy)
    r_facet = rotation_rpy(*facet_rpy)
    return r_facet.T @ r_cam
