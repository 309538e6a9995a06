"""Forms of B1's source compiled and timed beside each other on one GPU.

    python3 b1_forms.py FORM.cu [FORM.cu ...]

Each FORM.cu replaces rusterix_tpu_torch/csrc/megakernel.cu whole and keeps
its C interface (`rx_mega_render` with the `has_blend` and `mat` arguments;
a form of an earlier tree, which has no `mat`, gets it added to its
rx_mega_render, unused). For each form this prints ptxas's report of each
compiled entry of `mega_kernel` (registers, stack frame, spill stores and
loads; compiled with the package's own nvcc flags), links it with the
checkout's other kernel sources into a library of its own, and times B1
alone (`megakernel.prepare_launch`, CUDA events, median of 200 after 5
warm-up launches) at stage_cut 0 and 1 on the 1920x1080 inputs of paths A
(the opaque map), G (the shadowed map) and K (the blended map; only for
forms whose source has the blend branch), and of paths O (the shaded cube,
800x600) and Q (the material map; only for forms whose source has the
material template), the forms in turns (forward, backward, forward,
backward) within one process. Every line names the card and its power
limit. Needs a GPU; imports no jax.
"""

from __future__ import annotations

import os
import subprocess
import sys

import chip_smoke as cs


def build(form: str, out_dir: str) -> tuple:
    """Compile `form` with the package's other sources into out_dir ->
    (library path, ptxas summary of each entry of mega_kernel)."""
    from rusterix_tpu_torch import _cuda

    csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rusterix_tpu_torch", "csrc")
    os.makedirs(out_dir, exist_ok=True)
    text = open(form).read()
    if "int mat," not in text:
        old = "int has_blend, void* stream) {"
        if old not in text:
            raise SystemExit(f"{form}: no rx_mega_render with the has_blend argument")
        form = os.path.join(out_dir, os.path.basename(form))
        with open(form, "w") as f:
            f.write(text.replace(old, "int has_blend, int mat, void* stream) {"))
    sources = [form] + [s for s in _cuda.SOURCES if not s.endswith("megakernel.cu")]
    procs = []
    for src in sources:
        obj = os.path.join(out_dir, os.path.basename(src) + ".o")
        cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", csrc, "-c", "-o", obj, src]
        procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    report = ""
    for i, (obj, proc) in enumerate(procs):
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"{sources[i]}: nvcc failed\n{out[-3000:]}")
        if i == 0:
            report = "; ".join(f"{k}: {v}" for k, v in
                               sorted(_cuda.ptxas_report(out, "mega_kernel").items()))
    lib = os.path.join(out_dir, "lib.so")
    subprocess.run([_cuda.nvcc_path(), "-shared", "-o", lib, *(o for o, _p in procs)],
                   check=True, capture_output=True)
    return lib, report


def main() -> int:
    forms = [os.path.abspath(f) for f in sys.argv[1:]]
    if not forms:
        raise SystemExit(__doc__)
    import torch

    from rusterix_tpu_torch import _cuda, scenes
    from rusterix_tpu_torch.ops import megakernel
    from rusterix_tpu_torch.ops.raster import frame_inputs

    if not torch.cuda.is_available():
        raise SystemExit("b1_forms: torch.cuda.is_available() is False")
    gpu = cs._run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    gpu = gpu.splitlines()[0]
    libs = {}
    for i, form in enumerate(forms):
        libs[form], report = build(form, os.path.join(_cuda.BUILD_DIR, f"form{i}"))
        print(f"ptxas mega_kernel, {os.path.basename(form)}: {report}")

    def use(form):
        _cuda._lib = None
        _cuda.build = lambda force=False, path=libs[form]: path
        return _cuda.library()

    use(forms[0])
    inputs = {}
    for key, make, (w, h) in (
            ("A", scenes.build_map_scene, (cs.W, cs.H)),
            ("G", scenes.build_map_shadow_scene, (cs.W, cs.H)),
            ("K", scenes.build_map_blend_scene, (cs.W, cs.H)),
            ("O", scenes.build_cube_shaded_scene, (800, 600)),
            ("Q", scenes.build_map_material_scene, (cs.W, cs.H))):
        rast, scene, assets = make(w, h, device="cuda")
        rast.rasterize(scene, w, h, 40, assets)
        fi = frame_inputs(**rast.frame_args)
        inputs[key] = (fi["mega_args"], fi["mega_kwargs"])
    blend = {f: "a.has_blend" in open(f).read() for f in forms}
    material = {f: "template <int MAT>" in open(f).read() for f in forms}
    times = {}
    for form in forms + forms[::-1] + forms + forms[::-1]:
        use(form)
        for key, (args, kwargs) in inputs.items():
            if (key == "K" and not blend[form]) or (key in "OQ" and not material[form]):
                continue
            for cut in (0, 1):
                launch = megakernel.prepare_launch(*args, **kwargs, stage_cut=cut)
                times.setdefault((key, cut, form), []).append(
                    cs.median(cs.cuda_times(launch, 200, warmup=5)))
    for (key, cut, form), ts in sorted(times.items()):
        print(f"B1 alone, path {key}, stage_cut {cut}, {os.path.basename(form)}: "
              + ", ".join(f"{t:.4f}" for t in ts) + f" ms, mean {sum(ts) / len(ts):.4f} ms on {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
