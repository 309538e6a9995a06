"""Row-sharded frames over a mesh of torch devices (counterpart of
`rusterix_tpu/parallel/mesh.py`).

A mesh is a tuple of torch devices, one per slab, that the caller names:
`make_mesh(8, device="cuda")` is eight slabs on one card, the counterpart of
the eight virtual CPU devices of the JAX package's tests. The frame splits
as the JAX package's `shard_map` splits it:

  * geometry over the triangles: the setup pass runs on each 1/n shard of
    the triangle pack on its slab's device, and the shards' planes are
    concatenated in order (the JAX package's tiled `all_gather`); the
    candidate's triangle id follows the concatenated order;
  * the framebuffer over rows: each slab owns ceil(height / n) rows and
    runs the megakernel (B1) at its row offset (or, with runtime shaders,
    the split path: B2 over the Morton-ordered candidates at its row
    offset and shade_pass on its rows), the visibility pre-pass
    (B2), the reflections and the sky light (B3), the sky miss pass, the
    brush preview, the depth-peeled opacity layers (their setup replicated,
    their peel row-local, their reflections traced against the gathered
    opaque pack) and the 2D pass on its own rows. Rows past the frame's
    height (the overhang of the last slab) render the background and are
    cropped. Ambient occlusion is the one pass whose taps cross slabs: the
    slabs' (z, hit) are gathered first, the factor is computed once over
    the whole frame and sliced.

Each slab runs the single frame's own code on its rows
(`ops.raster.frame_inputs` and `compose_rows`). The gathers are `torch.cat` of `.to(device)` copies. The slabs run one
after another in one process: no torch.distributed, no threads. A mesh of
several cards follows from the same code; the port's tests and its chip
runs use one card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.raster import (
    ambient_occlusion,
    compose_rows,
    frame_inputs,
    frame_setup,
    needs_prepass,
    opacity_setup,
    opaque_rows,
    visibility_prepass,
)
from ..ops.setup_pass import setup_pass


def make_mesh(n_devices: int, device="cuda") -> tuple:
    """A mesh of `n_devices` slabs, all on `device` (None is CUDA, which
    raises without a GPU) -> a tuple of torch devices."""
    if int(n_devices) < 1:
        raise ValueError(f"make_mesh: {n_devices} slabs")
    return (resolve_device(device),) * int(n_devices)


def check_mesh(mesh) -> tuple:
    """mesh (a tuple or list of torch devices or device names) -> a tuple
    of torch devices; anything else raises TypeError."""
    if not isinstance(mesh, (tuple, list)) or not mesh:
        raise TypeError(f"mesh= takes a non-empty tuple of torch devices (make_mesh), not "
                        f"{type(mesh).__name__}")
    if not all(isinstance(d, (torch.device, str)) for d in mesh):
        raise TypeError("mesh= takes a tuple of torch devices (make_mesh)")
    return tuple(resolve_device(d) for d in mesh)


def _pad_rows(t: torch.Tensor, n: int, value: float = 0.0) -> torch.Tensor:
    """t with its first axis padded by n rows of `value`."""
    if n == 0:
        return t
    return torch.cat([t, torch.full((n,) + tuple(t.shape[1:]), value, dtype=t.dtype,
                                    device=t.device)])


def sharded_inputs(mesh, d3, lights, atlas, uniforms, background, width: int, height: int,
                   d3_op=None, has_opacity: bool = False, d2=None, shadow_rows=None,
                   has_blend: bool = False, has_material: bool = False,
                   has_matmap: bool = False, **settings) -> list:
    """The sharded frame's preparation before its kernels -> one dict a
    slab: ops.raster.frame_inputs of its rows (`y0`, `rows`, the sorted
    candidates, `mega_args` and `mega_kwargs`, with the slab's rows of the
    AO factor as mega_kwargs["ao_img"]; on the split path no B1
    arguments), its `device`, its pre-pass `pre` (z, idx, hit) where AO,
    reflections, the sky light or the split path need it (else None), and
    `local`, what the slabs on its device share: the padded pack
    `d3`, `atlas`, `d2`, `shadow_rows`, and with opacity batches `d3_op`
    and its setup `op_setup`. Takes render_frame_sharded's arguments."""
    mesh = check_mesh(mesh)
    n = len(mesh)
    rows = -(-height // n)
    hp = rows * n
    cap = int(d3["valid"].shape[0])
    d3 = {k: _pad_rows(v, (-cap) % n) for k, v in d3.items()}
    per = int(d3["valid"].shape[0]) // n
    background = _pad_rows(background, hp - height)
    view = torch.from_numpy(np.asarray(uniforms["view"], np.float32))
    proj = torch.from_numpy(np.asarray(uniforms["proj"], np.float32))
    flags = {"has_blend": has_blend, "has_material": has_material, "has_matmap": has_matmap}
    split = bool(settings.get("shaders"))

    # the setup pass on each triangle shard, then the planes gathered
    parts = []
    for k, dev in enumerate(mesh):
        sh = {f: d3[f][k * per:(k + 1) * per].to(dev)
              for f in ("pos", "uv", "nrm", "valid", "cull", "bw") if f in d3}
        parts.append(setup_pass(
            sh["pos"], sh["uv"], sh["nrm"], sh["valid"], sh["cull"], view.to(dev),
            proj.to(dev), width, height, bw=sh["bw"] if has_blend else None)[:4])

    local = {}
    for dev in dict.fromkeys(mesh):
        vis, attr, bbox, alive = (torch.cat([p[i].to(dev) for p in parts]) for i in range(4))
        tri_id = torch.arange(vis.shape[0] // 2, dtype=torch.int32, device=dev)
        r = {
            "d3": {k: v.to(dev) for k, v in d3.items()},
            "atlas": {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                      for k, v in atlas.items()},
            "d2": None if d2 is None else {k: v.to(dev) for k, v in d2.items()},
            "shadow_rows": None if shadow_rows is None else shadow_rows.to(dev),
            "d3_op": None, "op_setup": None,
        }
        r["setup"] = frame_setup(r["d3"], lights, r["atlas"], uniforms, width, height,
                                 planes=(vis, attr, bbox, alive, tri_id.repeat_interleave(2)),
                                 split=split, **flags)
        if has_opacity:
            r["d3_op"] = {k: v.to(dev) for k, v in d3_op.items()}
            r["op_setup"] = opacity_setup(r["d3_op"], uniforms, width, height)
        local[dev] = r

    # each slab's candidates sorted with the near bound clipped to its rows,
    # and, where a pass needs the winners before shading, its pre-pass (B2)
    need_pre = needs_prepass(**settings)
    slabs = []
    for k, dev in enumerate(mesh):
        r = local[dev]
        y0 = k * rows
        fi = frame_inputs(r["d3"], lights, r["atlas"], uniforms,
                          background[y0:y0 + rows].to(dev), width, height,
                          shadow_rows=r["shadow_rows"], y0=y0, rows=rows, shared=r["setup"],
                          **flags, **settings)
        fi["device"], fi["local"] = dev, r
        fi["pre"] = visibility_prepass(fi, width, rows, y0) if need_pre else None
        fi["mega_kwargs"]["ao_img"] = None
        slabs.append(fi)

    ao_taps = settings.get("ao_taps")
    if ao_taps:
        # the taps cross slabs: the whole frame's (z, hit), the factor once
        dev0 = mesh[0]
        z_full = torch.cat([fi["pre"][0].to(dev0) for fi in slabs])[:height]
        hit_full = torch.cat([fi["pre"][2].to(dev0) for fi in slabs])[:height]
        ao_full = _pad_rows(ambient_occlusion((z_full, None, hit_full), uniforms, height, ao_taps),
                            hp - height, 1.0)
        for fi in slabs:
            fi["mega_kwargs"]["ao_img"] = (
                ao_full[fi["y0"]:fi["y0"] + rows].to(fi["device"]).contiguous())
    return slabs


def render_frame_sharded(mesh, d3, d2, lights, atlas, uniforms, background, width: int,
                         height: int, sample_mode: int = 0, has_ambient: bool = False,
                         has_lights: bool = False, has_d2: bool = False, **settings):
    """One frame with its triangles and rows split over `mesh` -> (H, W, 4)
    uint8 tensor on the mesh's first device, byte-equal to the port's
    render_frame with the same settings at full-resolution reflections but
    for pixels where two candidates tie on 1/z bit for bit (a slab's scan
    order, its supers sorted by the near bound over its own rows, can keep
    another of them first than the whole frame's order does; the split
    path's Morton order is the whole frame's on every slab).

    d3, d2, d3_op, atlas: packed_to_torch tensors; lights, uniforms: the
    host (numpy) dicts of the Rasterizer; background (H, W, 4) f32; the
    positional arguments in the JAX package's order, and `settings` the
    keyword arguments of ops.raster.render_frame but `refl_scale`. Each
    slab runs frame_inputs and compose_rows on its rows, as render_frame
    runs them on all of them. `light_spec` (the (row, type code) pairs of
    the valid light rows) specialises B1's light loop; None (the default,
    as in the JAX package) runs its generic loop, which reads the types
    from the light table on the device. A height or a triangle capacity
    that the mesh size does not divide is padded: each slab owns
    ceil(height / n) rows, and dead triangle slots fill the last shard.
    The JAX package's one backend switch (`use_pallas`) has no counterpart
    here; where it forces its XLA backend for runtime shaders, this frame
    takes the split path (`shaders`), as the single frame does. Its sky
    miss pass takes the slab's row count for the frame's height; this one
    takes the frame's."""
    frame = dict(settings, sample_mode=sample_mode, has_ambient=has_ambient,
                 has_lights=has_lights, has_d2=has_d2)
    slabs = sharded_inputs(mesh, d3, lights, atlas, uniforms, background, width, height,
                           d2=d2, **frame)
    out = []
    for fi in slabs:
        r = fi["local"]
        ao_img = fi["mega_kwargs"]["ao_img"]
        slab = dict(frame, d2=r["d2"], shadow_rows=r["shadow_rows"], d3_op=r["d3_op"],
                    op_setup=r["op_setup"])
        opaque, z_eff = opaque_rows(fi, fi["pre"], ao_img, r["d3"], lights, r["atlas"],
                                    uniforms, width, height, **slab)
        out.append(compose_rows(fi, opaque, z_eff, fi["pre"], ao_img, r["d3"], lights,
                                r["atlas"], uniforms, width, height, **slab))
    return torch.cat([f.to(slabs[0]["device"]) for f in out])[:height]


def render_sharded_jit(mesh, width: int, height: int, sample_mode: int = 0,
                       has_ambient: bool = False, has_lights: bool = False,
                       has_d2: bool = False, **flags):
    """render_frame_sharded over a fixed mesh, size and settings -> a
    function of the frame's data (d3, d2, lights, atlas, uniforms,
    background, d3_op=None, shadow_rows=None, shadow_params=None,
    sky_pre=None) that renders it. The JAX package jit-compiles this
    closure; here it is a plain closure (the kernels are built once and
    each call launches them)."""
    mesh = check_mesh(mesh)

    def run(d3, d2, lights, atlas, uniforms, background, d3_op=None, shadow_rows=None,
            shadow_params=None, sky_pre=None):
        return render_frame_sharded(
            mesh, d3, d2, lights, atlas, uniforms, background, width, height, sample_mode,
            has_ambient, has_lights, has_d2, d3_op=d3_op, shadow_rows=shadow_rows,
            shadow_params=shadow_params, sky_pre=sky_pre, **flags)

    return run
