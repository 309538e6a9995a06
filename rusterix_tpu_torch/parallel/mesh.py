"""Row-sharded frames over a mesh of torch devices (counterpart of
`rusterix_tpu/parallel/mesh.py`).

A mesh is a tuple of torch devices, one per slab. `card_mesh(n)` is the
first n CUDA cards of the machine, one slab each (all of them by default):
the counterpart of the JAX package's `make_mesh(n)`, which takes the first n
of `jax.devices()`. `make_mesh(8, device="cuda")` is eight slabs on one
device, the counterpart of the eight virtual CPU devices of the JAX
package's tests. The frame splits as the JAX package's `shard_map` splits
it:

  * geometry over the triangles: the setup pass runs on each 1/n shard of
    the triangle pack on its slab's device, and the shards' planes are
    concatenated in order on every device (the JAX package's tiled
    `all_gather`); the candidate's triangle id follows the concatenated
    order;
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
    slabs' (z, hit) are gathered on the first device, the factor is
    computed once over the whole frame and each slab's rows go back to it.

Each slab runs the single frame's own code on its rows
(`ops.raster.frame_inputs` and `compose_rows`), on its own device. One
process drives every device, as one JAX controller drives a mesh: no
torch.distributed and no threads. Each device's work is queued device after
device with no host wait between them, so the cards of a card mesh work at
the same time; the gathers are `.to(device)` copies, which PyTorch orders
after the source device's queued work by events, not through the host.

What the JAX package replicates once (`P()` operands: the padded triangle
pack, the atlas, the 2D pack, the opacity pack, the shadow rows, the sky's
parameters) and the background's rows are placed on each device once and
kept in a `placed` store (the Rasterizer keeps it with its scene cache
entry, so it goes when the scene goes); an entry is replaced when its
source tensor is another object (a new scene revision, a moved shadow
caster, a dynamic pack concatenated anew, as the JAX package moves those
every frame). Each frame moves the lights, the uniforms and their packs to
each device, gathers the planes (and with AO the pre-pass's z and hit) and
gathers the slabs' rows on the first device.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.arena import Staged, leaf
from ..ops.composite import d2_lists
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


def card_mesh(n_cards: int = None) -> tuple:
    """The first `n_cards` CUDA cards of the machine, one slab each (every
    card when None) -> (cuda:0, ..., cuda:n-1). Raises when CUDA is missing
    or the machine has fewer cards than asked: it never gives fewer slabs,
    or another device, than asked."""
    if not torch.cuda.is_available():
        raise RuntimeError("card_mesh: torch.cuda.is_available() is False")
    count = torch.cuda.device_count()
    n = count if n_cards is None else int(n_cards)
    if n < 1:
        raise ValueError(f"card_mesh: {n_cards} cards")
    if n > count:
        raise RuntimeError(f"card_mesh: {n} cards asked for, the machine has {count}")
    return tuple(torch.device("cuda", i) for i in range(n))


def check_mesh(mesh) -> tuple:
    """mesh (a tuple or list of torch devices or device names) -> a tuple
    of torch devices, a CUDA device without an index taken as the current
    one; anything else raises TypeError, a card the machine lacks
    RuntimeError (resolve_device)."""
    if not isinstance(mesh, (tuple, list)) or not mesh:
        raise TypeError(f"mesh= takes a non-empty tuple of torch devices (make_mesh), not "
                        f"{type(mesh).__name__}")
    if not all(isinstance(d, (torch.device, str)) for d in mesh):
        raise TypeError("mesh= takes a tuple of torch devices (make_mesh)")
    out = []
    for d in mesh:
        d = resolve_device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return tuple(out)


def _pad_rows(t: torch.Tensor, n: int, value: float = 0.0) -> torch.Tensor:
    """t with its first axis padded by n rows of `value`."""
    if n == 0:
        return t
    return torch.cat([t, torch.full((n,) + tuple(t.shape[1:]), value, dtype=t.dtype,
                                    device=t.device)])


class _Placed:
    """A view of a `placed` store for one call: `get(key, src, make)` gives
    the value kept under `key` while its source `src` is the same object,
    else make()'s, kept; `prune()` drops the entries the call did not ask
    for."""

    def __init__(self, store):
        self.store = {} if store is None else store
        self.used = set()

    def get(self, key, src, make):
        self.used.add(key)
        hit = self.store.get(key)
        if hit is not None and hit[0] is src:
            return hit[1]
        value = make()
        self.store[key] = (src, value)
        return value

    def tensors(self, role, tree, dev, prep=lambda t: t):
        """A dict's tensors (`prep`ped) on `dev`, each placed once; other
        values as they are; None as None."""
        if tree is None:
            return None
        return {k: self.get((role, k, dev), v, lambda v=v: prep(v).to(dev))
                if isinstance(v, torch.Tensor) else v for k, v in tree.items()}

    def prune(self):
        for key in [k for k in self.store if k not in self.used]:
            del self.store[key]


def _staged_on(d, dev):
    """d (the lights or the uniforms) with its device leaves and packs on
    `dev`: a Staged dict whose leaves lie on another device is copied (once
    a frame and device); anything else is returned as it is."""
    if not isinstance(d, Staged) or all(t.device == dev for t in d.dev.values()):
        return d
    return Staged(d, {k: t.to(dev) for k, t in d.dev.items()},
                  {name: (key, t.to(dev)) for name, (key, t) in d.packs.items()})


def sharded_inputs(mesh, d3, lights, atlas, uniforms, background, width: int, height: int,
                   d3_op=None, has_opacity: bool = False, d2=None, shadow_rows=None,
                   has_blend: bool = False, has_material: bool = False,
                   has_matmap: bool = False, placed: dict = None, staged: dict = None,
                   **settings) -> list:
    """The sharded frame's preparation before its kernels -> one dict a
    slab: ops.raster.frame_inputs of its rows (`y0`, `rows`, the sorted
    candidates, `mega_args` and `mega_kwargs`, with the slab's rows of the
    AO factor as mega_kwargs["ao_img"]; on the split path no B1
    arguments), its `device`, its triangle shard `shard`, its pre-pass
    `pre` (z, idx, hit) where AO, reflections, the sky light or the split
    path need it (else None), and `local`, what the slabs on its device
    share: the padded pack `d3`, `atlas`, `d2`, `shadow_rows`, `sky_pre`
    and with opacity batches `d3_op` (placed once, see the module's
    docstring), and this frame's `lights`, `uniforms`, `setup` and, with
    opacity batches, `op_setup` on the device. Takes render_frame_sharded's
    arguments; `placed`: the store that keeps what is placed once between
    calls (None: placed anew for this call); `staged`: device -> (lights,
    uniforms) as arena.Staged dicts over the frame's arena uploaded to that
    device (ops.raster.staged_dicts), for the devices that have one; on the
    others a Staged dict's device leaves are copied there."""
    mesh = check_mesh(mesh)
    store = _Placed(placed)
    n = len(mesh)
    rows = -(-height // n)
    hp = rows * n
    cap = int(d3["valid"].shape[0])
    per = -(-cap // n)
    flags = {"has_blend": has_blend, "has_material": has_material, "has_matmap": has_matmap}
    split = bool(settings.get("shaders"))

    # each device's static state, placed once: the pack padded to the mesh
    local = {}
    for dev in dict.fromkeys(mesh):
        local[dev] = {
            "d3": store.tensors(("d3", n), d3, dev,
                                lambda t: _pad_rows(t, (-cap) % n)),
            "atlas": store.tensors("atlas", atlas, dev),
            "d2": store.tensors("d2", d2, dev),
            "shadow_rows": None if shadow_rows is None else store.get(
                ("shadow_rows", dev), shadow_rows, lambda: shadow_rows.to(dev)),
            "sky_pre": store.tensors("sky_pre", settings.get("sky_pre"), dev),
            "d3_op": store.tensors("d3_op", d3_op, dev) if has_opacity else None,
        }
        local[dev]["lights"], local[dev]["uniforms"] = (
            staged[dev] if staged and dev in staged
            else (_staged_on(lights, dev), _staged_on(uniforms, dev)))

    # the setup pass on each triangle shard, then the planes gathered on
    # every device
    parts = []
    shards = []
    for k, dev in enumerate(mesh):
        r = local[dev]
        sh = {f: r["d3"][f][k * per:(k + 1) * per]
              for f in ("pos", "uv", "nrm", "valid", "cull", "bw") if f in r["d3"]}
        shards.append(sh)
        parts.append(setup_pass(
            sh["pos"], sh["uv"], sh["nrm"], sh["valid"], sh["cull"],
            leaf(r["uniforms"], "view", dev, torch.float32),
            leaf(r["uniforms"], "proj", dev, torch.float32), width, height,
            bw=sh["bw"] if has_blend else None)[:4])

    for dev, r in local.items():
        vis, attr, bbox, alive = (torch.cat([p[i].to(dev) for p in parts]) for i in range(4))
        tri_id = torch.arange(vis.shape[0] // 2, dtype=torch.int32, device=dev)
        r["setup"] = frame_setup(r["d3"], r["lights"], r["atlas"], r["uniforms"], width,
                                 height, planes=(vis, attr, bbox, alive,
                                                 tri_id.repeat_interleave(2)),
                                 split=split, **flags)
        r["op_setup"] = (opacity_setup(r["d3_op"], r["uniforms"], width, height)
                         if has_opacity else None)

    # each slab's candidates sorted with the near bound clipped to its rows,
    # and, where a pass needs the winners before shading, its pre-pass (B2)
    need_pre = needs_prepass(**settings)
    slabs = []
    for k, dev in enumerate(mesh):
        r = local[dev]
        y0 = k * rows
        bg = store.get(("background", n, k, dev), background,
                       lambda: _pad_rows(background, hp - height)[y0:y0 + rows].to(dev))
        fi = frame_inputs(r["d3"], r["lights"], r["atlas"], r["uniforms"], bg, width, height,
                          shadow_rows=r["shadow_rows"], y0=y0, rows=rows, shared=r["setup"],
                          **flags, **dict(settings, sky_pre=r["sky_pre"]))
        fi["device"], fi["local"], fi["shard"] = dev, r, shards[k]
        fi["pre"] = visibility_prepass(fi, width, rows, y0) if need_pre else None
        fi["mega_kwargs"]["ao_img"] = None
        slabs.append(fi)
    store.prune()

    ao_taps = settings.get("ao_taps")
    if ao_taps:
        # the taps cross slabs: the whole frame's (z, hit), the factor once
        dev0 = mesh[0]
        z_full = torch.cat([fi["pre"][0].to(dev0) for fi in slabs])[:height]
        hit_full = torch.cat([fi["pre"][2].to(dev0) for fi in slabs])[:height]
        ao_full = _pad_rows(ambient_occlusion((z_full, None, hit_full), local[dev0]["uniforms"],
                                              height, ao_taps),
                            hp - height, 1.0)
        for fi in slabs:
            fi["mega_kwargs"]["ao_img"] = (
                ao_full[fi["y0"]:fi["y0"] + rows].to(fi["device"]).contiguous())
    return slabs


def render_frame_sharded(mesh, d3, d2, lights, atlas, uniforms, background, width: int,
                         height: int, sample_mode: int = 0, has_ambient: bool = False,
                         has_lights: bool = False, has_d2: bool = False, placed: dict = None,
                         staged: dict = None, **settings):
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
    takes the frame's. `placed` and `staged`: sharded_inputs'."""
    frame = dict(settings, sample_mode=sample_mode, has_ambient=has_ambient,
                 has_lights=has_lights, has_d2=has_d2)
    slabs = sharded_inputs(mesh, d3, lights, atlas, uniforms, background, width, height,
                           d2=d2, placed=placed, staged=staged, **frame)
    # the 2D pass's host lists, read once a frame from the pack on the
    # first device (one host wait, as the single frame's)
    lists = d2_lists(d2, settings.get("shaders", ())) if has_d2 else None
    out = []
    for fi in slabs:
        r = fi["local"]
        ao_img = fi["mega_kwargs"]["ao_img"]
        slab = dict(frame, d2=r["d2"], shadow_rows=r["shadow_rows"], d3_op=r["d3_op"],
                    op_setup=r["op_setup"], sky_pre=r["sky_pre"], d2_lists=lists)
        opaque, z_eff = opaque_rows(fi, fi["pre"], ao_img, r["d3"], r["lights"], r["atlas"],
                                    r["uniforms"], width, height, **slab)
        out.append(compose_rows(fi, opaque, z_eff, fi["pre"], ao_img, r["d3"], r["lights"],
                                r["atlas"], r["uniforms"], width, height, **slab))
    return torch.cat([f.to(slabs[0]["device"]) for f in out])[:height]


def render_sharded_jit(mesh, width: int, height: int, sample_mode: int = 0,
                       has_ambient: bool = False, has_lights: bool = False,
                       has_d2: bool = False, **flags):
    """render_frame_sharded over a fixed mesh, size and settings -> a
    function of the frame's data (d3, d2, lights, atlas, uniforms,
    background, d3_op=None, shadow_rows=None, shadow_params=None,
    sky_pre=None) that renders it. The JAX package jit-compiles this
    closure; here it is a plain closure (the kernels are built once and
    each call launches them; what is placed once on each device is kept
    between calls)."""
    mesh = check_mesh(mesh)
    placed = {}

    def run(d3, d2, lights, atlas, uniforms, background, d3_op=None, shadow_rows=None,
            shadow_params=None, sky_pre=None):
        return render_frame_sharded(
            mesh, d3, d2, lights, atlas, uniforms, background, width, height, sample_mode,
            has_ambient, has_lights, has_d2, d3_op=d3_op, shadow_rows=shadow_rows,
            shadow_params=shadow_params, sky_pre=sky_pre, placed=placed, **flags)

    return run
