"""Host-side affine transform helpers (numpy).

Port of henjou_tpu/math/affine.py, unchanged: it is numpy-only.

Rebuild of the reference's Affine4x4 (include/common/matrix.h:6-104) and
Matrix4x3 (include/cu/matrix_4x3.h). We standardize on row-major 3x4
matrices ("upper 3 rows of a 4x4"), the same layout OptixInstance uses, so
instance-transform semantics carry over directly.
"""

from __future__ import annotations

import numpy as np


def identity_affine() -> np.ndarray:
    m = np.zeros((3, 4), dtype=np.float32)
    m[:, :3] = np.eye(3, dtype=np.float32)
    return m


def translate_affine(t) -> np.ndarray:
    m = identity_affine()
    m[:, 3] = np.asarray(t, dtype=np.float32)
    return m


def scale_affine(s) -> np.ndarray:
    m = identity_affine()
    s = np.asarray(s, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = s[0], s[1], s[2]
    return m


def rotate_affine(q) -> np.ndarray:
    """Unit-quaternion (x, y, z, w) to rotation affine.
    reference: include/common/matrix.h rotateAffine (glTF quaternion order)."""
    x, y, z, w = [float(v) for v in q]
    n = x * x + y * y + z * z + w * w
    if n < 1e-12:
        return identity_affine()
    s = 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    m = identity_affine()
    m[0, :3] = [1.0 - (yy + zz), xy - wz, xz + wy]
    m[1, :3] = [xy + wz, 1.0 - (xx + zz), yz - wx]
    m[2, :3] = [xz - wy, yz + wx, 1.0 - (xx + yy)]
    return m


def compose_affine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a ∘ b on 3x4 affines (apply b first)."""
    out = np.zeros((3, 4), dtype=np.float32)
    out[:, :3] = a[:, :3] @ b[:, :3]
    out[:, 3] = a[:, :3] @ b[:, 3] + a[:, 3]
    return out


def invert_affine(m: np.ndarray) -> np.ndarray:
    """Inverse of a 3x4 affine (reference computes per-instance inverses with
    glm::inverse each frame, renderer.h:272-284)."""
    r = np.asarray(m, dtype=np.float64)
    inv_rot = np.linalg.inv(r[:, :3])
    out = np.zeros((3, 4), dtype=np.float32)
    out[:, :3] = inv_rot
    out[:, 3] = -inv_rot @ r[:, 3]
    return out


def apply_affine_point(m: np.ndarray, p) -> np.ndarray:
    p = np.asarray(p, dtype=np.float32)
    return m[:, :3] @ p + m[:, 3]


def apply_affine_vector(m: np.ndarray, v) -> np.ndarray:
    v = np.asarray(v, dtype=np.float32)
    return m[:, :3] @ v
