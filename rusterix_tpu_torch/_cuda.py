"""Build and load the port's CUDA kernels (csrc/*.cu).

The sources are compiled at first use with `nvcc`, one compiler process per
source and all of them at once, and linked into a shared library with a
plain C interface (`rx_*` functions), which is loaded with ctypes. The
build goes into `rusterix_tpu_torch/_build/` (git-ignored) and is
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

from .ops.rt_kernel import DEFAULT_KNOBS, RT_BH, RT_BW, RT_CELL

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCES = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu")))
#: B3's tuning knobs other than the defaults (RUSTERIX_TPU_RT_CELL, _RT_BH,
#: _RT_BW) go to nvcc as -D flags, and the build into a directory named
#: after them; the default build takes neither
KNOB_DEFINES = ([] if (RT_CELL, RT_BH, RT_BW) == DEFAULT_KNOBS
                else [f"-DRT_CELL={RT_CELL}", f"-DRT_BH={RT_BH}", f"-DRT_BW={RT_BW}"])
BUILD_DIR = os.path.join(_PKG, "_build", *(
    [f"rt_cell{RT_CELL}_bh{RT_BH}_bw{RT_BW}"] if KNOB_DEFINES else []))
LIBRARY = os.path.join(BUILD_DIR, "librusterix_kernels.so")
BUILD_LOG = os.path.join(BUILD_DIR, "build.log")

# -fmad=false: no contraction of a*b + c, so the kernels round like the plain
# torch versions (see the note in csrc/megakernel.cu); no fast math.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
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
    deps = SOURCES + glob.glob(os.path.join(_PKG, "csrc", "*.cuh"))
    stale = not os.path.exists(LIBRARY) or any(
        os.path.getmtime(s) > os.path.getmtime(LIBRARY) for s in deps
    )
    if not (force or stale):
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    tag = os.getpid()
    t0 = time.perf_counter()
    objects, procs = [], []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, *KNOB_DEFINES, "-c", "-o", obj, src]
        objects.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, proc in procs:
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += "\n(killed after 600 s)"
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out[-4000:]}")
    tmp = f"{LIBRARY}.{tag}.tmp"
    if not failed:
        cmd = [nvcc, "-shared", "-o", tmp, *objects]
        link = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        log.append(" ".join(cmd) + "\n" + link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr[-4000:]}")
    build_seconds = time.perf_counter() - t0
    with open(BUILD_LOG, "w") as f:
        f.write("\n".join(log))
    for obj in objects:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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
    lib.rx_mega_render.argtypes = [vp] * 16 + [i32, i32, i64] + [i32] * 15 + [vp]
    for fn, n_int in ((lib.rx_mega_resources, 4), (lib.rx_visibility_resources, 1),
                      (lib.rx_rt_resources, 2)):
        fn.restype = i32
        fn.argtypes = [i32] * n_int + [vp]
    lib.rx_mega_smem_bytes.restype = i64
    lib.rx_mega_smem_bytes.argtypes = [i32] * 3
    lib.rx_visibility.restype = i32
    lib.rx_visibility.argtypes = [vp] * 5 + [i32] * 4 + [vp]
    lib.rx_rt_intersect.restype = i32
    lib.rx_rt_intersect.argtypes = [vp] * 13 + [i32] * 5 + [vp]
    lib.rx_rt_prepare.restype = i32
    lib.rx_rt_prepare.argtypes = [vp] * 7 + [ctypes.c_float] + [vp] * 3 + [i32] * 5 + [vp]
    lib.rx_rt_prepare_large.restype = i32
    lib.rx_rt_prepare_large.argtypes = ([vp] * 7 + [ctypes.c_float] + [vp] * 4 + [i64]
                                        + [i32] * 5 + [vp])
    lib.rx_rt_prepare_cluster.restype = i32
    lib.rx_rt_prepare_cluster.argtypes = [vp] * 7 + [ctypes.c_float] + [vp] * 3 + [i32] * 6 + [vp]
    lib.rx_rt_cluster_resources.restype = i32
    lib.rx_rt_cluster_resources.argtypes = [i32, i32, vp]
    lib.rx_xla_fma.restype = i32
    lib.rx_xla_fma.argtypes = [vp] * 4 + [i64, vp]
    lib.rx_error_string.restype = ctypes.c_char_p
    lib.rx_error_string.argtypes = [i32]
    _lib = lib
    return _lib


def resources(kernel: str, *sizes: int) -> dict:
    """What the built `kernel` takes on the card: registers a thread, static
    and dynamic shared memory a block, and the blocks an SM holds at once.
    kernel and sizes: "mega" (supers, lights, occlusion boxes, and the
    material form: 0 none, 1 has_material, 2 has_matmap; 0 when left out),
    "visibility" (supers), "rt_walk" (), "rt_prepare" (cells),
    "rt_prepare_cluster" (cells, blocks a cluster; also the clusters the card
    holds at once), "rt_prepare_large" () (the global route's sorting pass,
    rt_prepare_large_kernel)."""
    lib = library()
    out = (ctypes.c_int * 5)()
    if kernel == "mega":
        err = lib.rx_mega_resources(*(tuple(sizes) + (0,) * (4 - len(sizes))), out)
    elif kernel == "visibility":
        err = lib.rx_visibility_resources(*sizes, out)
    elif kernel == "rt_walk":
        err = lib.rx_rt_resources(0, 0, out)
    elif kernel == "rt_prepare":
        err = lib.rx_rt_resources(1, *sizes, out)
    elif kernel == "rt_prepare_cluster":
        err = lib.rx_rt_cluster_resources(*sizes, out)
    elif kernel == "rt_prepare_large":
        err = lib.rx_rt_resources(2, 0, out)
    else:
        raise ValueError(f"no kernel named {kernel!r}")
    if err != 0:
        raise RuntimeError(f"resources({kernel}): CUDA error {err} ({error_string(err)})")
    res = {"registers": out[0], "smem_static": out[1], "smem_dynamic": out[2],
           "blocks_per_sm": out[3]}
    if kernel == "rt_prepare_cluster":
        res["clusters"] = out[4]
    return res


def ptxas_report(text: str, symbol: str) -> dict:
    """ptxas -v's lines about each compiled entry of the kernel `symbol` in
    `text` (a build log) -> {mangled entry name: its stack, spill and
    register lines joined}; a template kernel has one entry per instance
    (mega_kernel: _Z11mega_kernelILi0EE..., ILi1EE..., ILi2EE... for the
    material forms 0, 1 and 2)."""
    out, entry = {}, None
    mangled = f"_Z{len(symbol)}{symbol}"
    for line in text.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            name = line.split("'")[1] if "'" in line else line.split()[-1]
            entry = name if name.startswith(mangled) else None
        elif entry is not None and ("spill" in line or "Used" in line):
            out[entry] = " ".join(filter(None, (out.get(entry), " ".join(line.split()))))
    return out


def error_string(err: int) -> str:
    return library().rx_error_string(int(err)).decode()
