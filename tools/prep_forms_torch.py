"""Forms of B3's global preparation route compiled and timed beside each
other on one GPU.

    python3 tools/prep_forms_torch.py FORM.cu [FORM.cu ...]

Each FORM.cu replaces rusterix_tpu_torch/csrc/rt_kernel.cu whole and keeps
its C interface and its tile of rt_kernel.GLOBAL_TILE pairs (LG_TILE; the
launch refuses a scratch too small for a smaller tile); the checkout's own
csrc/rt_kernel.cu is a form like any other (for example LG_MINB changed in
a copy, timed against the source as it stands). For each form
this prints ptxas's report of the route's kernels (compiled with the
package's own nvcc flags), links it with the checkout's other kernel
sources into a library of its own, holds the route's boxes, tnear and slist
to rt_prepare bit for bit on the inputs of chip_smoke.py's C12 (1080p rays
over 28,700 cells, the route chosen by lowered limits) and GL (131,072
cells) with both kinds of keys, and times the route's kernels alone on
prepared inputs (`rt_kernel.prepare_launch`: CUDA events, median of 10
after 2 warm-up calls; the profiler's device ms, split by kernel), the forms
in turns (forward, backward) within one process. Every line names the card
and its power limit. Needs a GPU; imports no jax.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

SYMBOLS = ("rt_prepare_large_boxes", "rt_prepare_large_count", "rt_prepare_large_kernel")


def build(form: str, out_dir: str) -> tuple:
    """Compile `form` with the checkout's other kernel sources into a
    library in out_dir -> (its path, ptxas's summary of the route's
    kernels)."""
    from rusterix_tpu_torch import _cuda

    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.dirname(_cuda.SOURCES[0])
    procs = []
    for src in _cuda.SOURCES:
        rt = src.endswith("rt_kernel.cu")
        src = form if rt else src
        obj = os.path.join(out_dir, os.path.basename(src) + ".o")
        cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", csrc, "-c", "-o", obj, src]
        procs.append((src, rt, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)))
    report = ""
    for src, rt, _obj, proc in procs:
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"{src}: nvcc failed\n{out[-3000:]}")
        if rt:
            report = "; ".join(f"{k}: {v}" for sym in SYMBOLS
                               for k, v in sorted(_cuda.ptxas_report(out, sym).items()))
    lib = os.path.join(out_dir, "lib.so")
    subprocess.run([_cuda.nvcc_path(), "-shared", "-o", lib, *(p[2] for p in procs)],
                   check=True, capture_output=True)
    return lib, report


def main() -> int:
    forms = [os.path.abspath(f) for f in sys.argv[1:]]
    if not forms:
        raise SystemExit(__doc__)
    import torch

    from rusterix_tpu_torch import _cuda
    from rusterix_tpu_torch.ops import rt_kernel

    if not torch.cuda.is_available():
        raise SystemExit("prep_forms: torch.cuda.is_available() is False")
    gpu = cs._run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    gpu = gpu.splitlines()[0]
    libs = {}
    for i, form in enumerate(forms):
        libs[form], report = build(form, os.path.join(_cuda.BUILD_DIR, f"prepform{i}"))
        print(f"ptxas, form {os.path.basename(form)}: {report}")

    def use(form):
        _cuda._lib = None
        _cuda.build = lambda force=False, path=libs[form]: path
        return _cuda.library()

    cases = {}
    for label, cells in (("C12", cs.C12_CELLS), ("GL", cs.GL_CELLS)):
        for kind in cs.SWEEP_KEYS:
            args = cs.c12_inputs(cells, kind)
            ref = rt_kernel.rt_prepare(*args)
            sizes = rt_kernel._sizes(args[0].shape[0], cs.H, cs.W)
            scene = rt_kernel.scene_tables(args[0], args[1], args[8], cells, sizes["cell"])
            cases[(label, kind)] = (scene, rt_kernel._ray_fields(*args[2:8]), args[8], sizes,
                                    (ref["boxes"], ref["tnear"], ref["slist"]))
            del args, ref
    times = {}
    for form in forms + forms[::-1]:
        use(form)
        for (label, kind), (scene, fields, t_cap, sizes, ref) in cases.items():
            with cs.route_limits(PREPARE_MAX_CELLS=0, CLUSTER_MAX_CELLS=0):
                fn = rt_kernel.prepare_launch(scene, fields, t_cap, sizes)
            outs = fn()
            torch.cuda.synchronize()
            for name, got, want in zip(("boxes", "tnear", "slist"), outs, ref):
                if not torch.equal(got, want):
                    raise SystemExit(f"form {form}, {label} ({kind}): {name} differs from "
                                     f"rt_prepare's")
            split = {}
            dev = cs.prep_device_ms(fn, cs.ROUTE_KERNELS["global"], split=split)
            times.setdefault((label, kind, form), []).append(
                (cs.median(cs.cuda_times(fn, 10)), dev, split))
            del fn, outs
            torch.cuda.empty_cache()
    for (label, kind, form), ts in sorted(times.items()):
        shown = "; ".join(f"alone {a:.4f}, device {d:.4f} ("
                          + ", ".join(f"{k.removeprefix('rt_prepare_large_')} {v:.4f}"
                                      for k, v in s.items()) + ")" for a, d, s in ts)
        print(f"global route, {label} ({kind} keys), form {os.path.basename(form)}: {shown} ms, "
              f"bit-equal to rt_prepare, on {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
