"""Build and load the port's CUDA kernels (csrc/*.cu).

The sources are compiled at first use with `nvcc` into a shared library
with a plain C interface (`rx_*` functions), which is loaded with ctypes.
The build goes into `rusterix_tpu_torch/_build/` (git-ignored) and is
redone whenever a source is newer than the library. Nothing here runs when
the module is imported, so machines without `nvcc` import it freely.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCES = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu")))
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "librusterix_kernels.so")
BUILD_LOG = os.path.join(BUILD_DIR, "build.log")

# -fmad=false: no contraction of a*b + c, so the kernels round like the plain
# torch versions (see the note in csrc/megakernel.cu); no fast math.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]

_lib = None
build_seconds = None  # wall time of the last build in this process


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into LIBRARY if it is missing or stale -> its path.

    The compiler's output (register and shared-memory use per kernel from
    -Xptxas -v) is kept in BUILD_LOG."""
    global build_seconds
    stale = not os.path.exists(LIBRARY) or any(
        os.path.getmtime(s) > os.path.getmtime(LIBRARY) for s in SOURCES
    )
    if not (force or stale):
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *SOURCES]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    build_seconds = time.perf_counter() - t0
    with open(BUILD_LOG, "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rx_mega_render.restype = i32
    lib.rx_mega_render.argtypes = [vp] * 13 + [i32, i32, i64] + [i32] * 7 + [vp]
    lib.rx_visibility.restype = i32
    lib.rx_visibility.argtypes = [vp] * 5 + [i32] * 3 + [vp]
    lib.rx_rt_intersect.restype = i32
    lib.rx_rt_intersect.argtypes = [vp] * 8 + [i32] * 5 + [vp]
    lib.rx_error_string.restype = ctypes.c_char_p
    lib.rx_error_string.argtypes = [i32]
    _lib = lib
    return _lib


def error_string(err: int) -> str:
    return library().rx_error_string(int(err)).decode()
