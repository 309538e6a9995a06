"""ctypes loader for the native host runtime (native/rusterix_native.cpp).

Compiles on first use (g++ -O2 -shared) into native/build/; every consumer
falls back to the pure-Python implementation when the toolchain or binary is
unavailable, so the native layer is a pure accelerator, never a requirement.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "rusterix_native.cpp")
_BUILD_DIR = os.path.join(_ROOT, "native", "build")
_SO = os.path.join(_BUILD_DIR, "librusterix_native.so")

_lib = None
_tried = False


def _build() -> bool:
    if not os.path.exists(_SRC):
        return False
    os.makedirs(_BUILD_DIR, exist_ok=True)
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", _SO, _SRC],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception:
        return False


def lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        if not _build():
            return None
    try:
        l = ctypes.CDLL(_SO)
    except OSError:
        return None

    l.rx_earcut.restype = ctypes.c_int
    l.rx_earcut.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    l.rx_move_distance.restype = ctypes.c_int
    l.rx_move_distance.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_float,
    ]
    l.rx_draw_lines.restype = None
    l.rx_draw_lines.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
    ]
    l.rx_pack_triangles.restype = None
    l.rx_pack_triangles.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    _lib = l
    return _lib


def _fp(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def earcut_native(points) -> Optional[list]:
    """Simple-polygon earcut; returns flat index list or None (fallback)."""
    l = lib()
    if l is None:
        return None
    pts = np.ascontiguousarray(points, np.float64).reshape(-1, 2)
    n = len(pts)
    if n < 3:
        return []
    out = np.zeros(3 * (n - 2), np.int32)
    count = l.rx_earcut(_fp(pts, ctypes.c_double), n, _fp(out, ctypes.c_int))
    return out[: count * 3].tolist()


def move_distance_native(segments, start_pos, move, radius):
    """Swept-circle move; returns (new_pos, blocked) or None (fallback)."""
    l = lib()
    if l is None:
        return None
    segs = np.ascontiguousarray(segments, np.float32).reshape(-1, 4)
    pos = np.array(start_pos, np.float32)
    mv = np.ascontiguousarray(move, np.float32)
    blocked = l.rx_move_distance(
        _fp(segs, ctypes.c_float),
        len(segs),
        _fp(pos, ctypes.c_float),
        _fp(mv, ctypes.c_float),
        ctypes.c_float(radius),
    )
    return pos, bool(blocked)


def draw_lines_native(pixels, segments, colors) -> bool:
    """Bresenham batch into an RGBA8 frame; returns False on fallback."""
    l = lib()
    if l is None:
        return False
    segs = np.ascontiguousarray(segments, np.float32).reshape(-1, 4)
    cols = np.ascontiguousarray(colors, np.uint8).reshape(-1, 4)
    h, w = pixels.shape[:2]
    l.rx_draw_lines(
        _fp(pixels, ctypes.c_uint8),
        w,
        h,
        _fp(segs, ctypes.c_float),
        _fp(cols, ctypes.c_uint8),
        len(segs),
    )
    return True


def pack_triangles_native(verts, uvs, normals, indices):
    """Denormalize indexed tris -> (pos (T,3,4), uv (T,3,2), nrm (T,3,3))."""
    l = lib()
    if l is None:
        return None
    verts = np.ascontiguousarray(verts, np.float32)
    uvs = np.ascontiguousarray(uvs, np.float32)
    idx = np.ascontiguousarray(indices, np.int32)
    nt = len(idx)
    out_pos = np.zeros((nt, 3, 4), np.float32)
    out_uv = np.zeros((nt, 3, 2), np.float32)
    out_nrm = np.zeros((nt, 3, 3), np.float32)
    has_n = normals is not None and len(normals) == len(verts) and len(normals) > 0
    nrm = np.ascontiguousarray(normals, np.float32) if has_n else None
    l.rx_pack_triangles(
        _fp(verts, ctypes.c_float),
        _fp(uvs, ctypes.c_float),
        _fp(nrm, ctypes.c_float) if has_n else None,
        _fp(idx, ctypes.c_int32),
        nt,
        _fp(out_pos, ctypes.c_float),
        _fp(out_uv, ctypes.c_float),
        _fp(out_nrm, ctypes.c_float),
    )
    return out_pos, out_uv, out_nrm
