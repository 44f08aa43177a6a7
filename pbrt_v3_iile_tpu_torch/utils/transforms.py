"""Host-side 4x4 transform algebra (numpy, float64 internally).

Replaces the reference's Transform class (ref: src/core/transform.h:114) for
scene construction.  Device code never sees a Transform — geometry is
pre-transformed to world space at build time and cameras carry plain 4x4
matrices as jnp arrays.
"""

from __future__ import annotations

import numpy as np


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def translate(dx, dy, dz) -> np.ndarray:
    m = identity()
    m[0, 3], m[1, 3], m[2, 3] = dx, dy, dz
    return m


def scale(sx, sy, sz) -> np.ndarray:
    m = identity()
    m[0, 0], m[1, 1], m[2, 2] = sx, sy, sz
    return m


def rotate(angle_deg, x, y, z) -> np.ndarray:
    """Rotation about arbitrary axis (ref: transform.cpp Rotate)."""
    a = np.array([x, y, z], dtype=np.float64)
    a = a / np.linalg.norm(a)
    s = np.sin(np.deg2rad(angle_deg))
    c = np.cos(np.deg2rad(angle_deg))
    m = identity()
    m[0, 0] = a[0] * a[0] + (1 - a[0] * a[0]) * c
    m[0, 1] = a[0] * a[1] * (1 - c) - a[2] * s
    m[0, 2] = a[0] * a[2] * (1 - c) + a[1] * s
    m[1, 0] = a[0] * a[1] * (1 - c) + a[2] * s
    m[1, 1] = a[1] * a[1] + (1 - a[1] * a[1]) * c
    m[1, 2] = a[1] * a[2] * (1 - c) - a[0] * s
    m[2, 0] = a[0] * a[2] * (1 - c) - a[1] * s
    m[2, 1] = a[1] * a[2] * (1 - c) + a[0] * s
    m[2, 2] = a[2] * a[2] + (1 - a[2] * a[2]) * c
    return m


def look_at(eye, look, up) -> np.ndarray:
    """Camera-to-world transform (ref: transform.cpp LookAt).

    pbrt camera space: +z towards `look`, y = up.  Left-handed like pbrt.
    """
    eye = np.asarray(eye, dtype=np.float64)
    look = np.asarray(look, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    d = look - eye
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    rl = np.linalg.norm(right)
    if rl < 1e-12:
        raise ValueError("LookAt: up vector parallel to viewing direction")
    right /= rl
    new_up = np.cross(d, right)
    m = identity()
    m[0:3, 0] = right
    m[0:3, 1] = new_up
    m[0:3, 2] = d
    m[0:3, 3] = eye
    return m


def perspective(fov_deg: float, near: float, far: float) -> np.ndarray:
    """Projective camera-to-screen transform (ref: transform.cpp Perspective)."""
    persp = np.array(
        [
            [1, 0, 0, 0],
            [0, 1, 0, 0],
            [0, 0, far / (far - near), -far * near / (far - near)],
            [0, 0, 1, 0],
        ],
        dtype=np.float64,
    )
    inv_tan = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    return scale(inv_tan, inv_tan, 1.0) @ persp


def apply_point(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Apply 4x4 to points (..., 3) with homogeneous divide."""
    p = np.asarray(p, dtype=np.float64)
    ph = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3].T + m[3, 3]
    return ph / w[..., None]


def apply_vector(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    return np.asarray(v, dtype=np.float64) @ m[:3, :3].T


def apply_normal(m: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Normals transform by the inverse transpose (ref: transform.h:287)."""
    inv = np.linalg.inv(m)
    return np.asarray(n, dtype=np.float64) @ inv[:3, :3]


def inverse(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m)


def swaps_handedness(m: np.ndarray) -> bool:
    """(ref: transform.h SwapsHandedness) — det of upper 3x3 < 0."""
    return bool(np.linalg.det(m[:3, :3]) < 0.0)


# ---------------------------------------------------------------------------
# AnimatedTransform decomposition (ref: core/transform.cpp
# AnimatedTransform::Decompose — M = T R S with R extracted by polar
# decomposition via iterative averaging with the inverse transpose)
# ---------------------------------------------------------------------------

def decompose(m: np.ndarray):
    """Decompose an affine 4x4 into (T (3,), R quaternion (4,) wxyz,
    S (3,3))."""
    m = np.asarray(m, np.float64)
    T = m[:3, 3].copy()
    M = m[:3, :3].copy()
    R = M.copy()
    for _ in range(100):
        R_next = 0.5 * (R + np.linalg.inv(R.T))
        if np.max(np.abs(R_next - R)) < 1e-10:
            R = R_next
            break
        R = R_next
    S = np.linalg.inv(R) @ M
    return T, matrix_to_quat(R), S


def matrix_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> unit quaternion (w,x,y,z) (ref: quaternion.cpp
    Quaternion(Transform) Shepperd's method)."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    if tr > 0.0:
        w = np.sqrt(tr + 1.0) / 2.0
        s = 1.0 / (4.0 * w)
        return np.array([w, (R[2, 1] - R[1, 2]) * s,
                         (R[0, 2] - R[2, 0]) * s,
                         (R[1, 0] - R[0, 1]) * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0))
    q = np.zeros(4)
    q[1 + i] = 0.5 * s
    s = 0.5 / max(s, 1e-12)
    q[0] = (R[k, j] - R[j, k]) * s
    q[1 + j] = (R[j, i] + R[i, j]) * s
    q[1 + k] = (R[k, i] + R[i, k]) * s
    return q


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """(w,x,y,z) -> 3x3 rotation (works for numpy inputs; a jnp twin lives
    in ops/camera.py for per-ray interpolation)."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def quat_slerp(t: float, q0: np.ndarray, q1: np.ndarray) -> np.ndarray:
    """(ref: quaternion.cpp Slerp) — host-side twin of the device lerp."""
    q0 = np.asarray(q0, np.float64)
    q1 = np.asarray(q1, np.float64)
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = (1 - t) * q0 + t * q1
    else:
        th = np.arccos(np.clip(d, -1, 1))
        q = (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)
    return q / np.linalg.norm(q)
