"""Camera/projection matrix builders.

Pure-numpy equivalents of the vek matrix constructors the reference relies on
(`Mat4::look_at_rh`, `Mat4::perspective_fov_rh_zo`; used by the cameras in
reference src/camera/*.rs). Matrices are row-major 4x4 float32 and multiply
column vectors: ``clip = M @ v``.

These run host-side once per frame; the heavy per-vertex math happens in the
jitted setup pass (ops/setup_pass.py).
"""

from __future__ import annotations

import numpy as np


def _cross3(a, b):
    """3-vector cross without np.cross's moveaxis machinery (camera
    matrices rebuild per frame in the engine loop)."""
    return np.array(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ],
        a.dtype if hasattr(a, "dtype") else np.float32,
    )


def look_at_rh(eye, target, up) -> np.ndarray:
    """Right-handed look-at view matrix (vek Mat4::look_at_rh semantics)."""
    eye = np.asarray(eye, dtype=np.float32)
    target = np.asarray(target, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)

    f = target - eye
    fn = np.linalg.norm(f)
    # degenerate camera (eye == target): fall back to -Z forward instead of
    # emitting NaN rows (vek normalizes 0/0 to NaN too, but a NaN view matrix
    # poisons the whole frame; the reference never renders such a camera)
    f = f / fn if fn > 1e-12 else np.array([0.0, 0.0, -1.0], np.float32)
    s = _cross3(f, up)
    sn = np.linalg.norm(s)
    s = s / sn if sn > 1e-12 else np.array([1.0, 0.0, 0.0], np.float32)
    u = _cross3(s, f)

    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective_fov_rh_zo(
    fov_y_radians: float, width: float, height: float, near: float, far: float
) -> np.ndarray:
    """RH perspective with z in [0,1] (vek Mat4::perspective_fov_rh_zo).

    x' = w*x ; y' = h*y ; z' = z*far/(near-far) - far*near/(far-near) ; w' = -z
    where h = cot(fov_y/2), w = h * height / width.
    """
    h = np.cos(fov_y_radians / 2.0) / np.sin(fov_y_radians / 2.0)
    w = h * height / width
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = far / (near - far)
    m[2, 3] = -(far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def orthographic_rh_zo(
    left: float, right: float, bottom: float, top: float, near: float, far: float
) -> np.ndarray:
    """RH orthographic with z in [0,1] (vek Mat4::orthographic_rh_zo)."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = -1.0 / (far - near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -near / (far - near)
    return m


def mat3_translation_scale(tx: float, ty: float, scale: float) -> np.ndarray:
    """2D projection matrix: scale then translate (used by Batch2D.project)."""
    m = np.eye(3, dtype=np.float32)
    m[0, 0] = scale
    m[1, 1] = scale
    m[0, 2] = tx
    m[1, 2] = ty
    return m


def invert(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m.astype(np.float64)).astype(np.float32)
