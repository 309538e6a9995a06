"""One upload a frame for the per-frame leaves (counterpart of
`rusterix_tpu/ops/arena.py`).

A frame's small host leaves (the dynamic packs, the lights, the uniforms and
the packs derived from them) would each be a host-to-device copy of its
own; from pageable memory each such copy waits for the kernels already
queued, so every mid-frame upload is also a host-device sync point.
`pack_arena` flattens the tree of 4-byte numpy leaves into one uint32
buffer plus a layout (offsets, shapes, dtypes and the tree's structure);
`upload` sends it to the card in one non-blocking copy from a pinned
staging buffer (counted in profiling's `arena.upload`), and `unpack_arena`
views the leaves back out of the device buffer (`narrow`, a same-width
`view(dtype)` and `reshape`: no copy).

`Staged` carries a host dict (the lights, the uniforms) together with the
device views of its leaves: item access still gives the numpy leaf, which
the host's decisions read (the light spec, the animation frame, the
`has_*` flags), and `leaf` gives the device view where there is one.

The layout walk visits dict keys in sorted order, as `jax.tree_util` does,
so the arena's words equal the JAX package's for the same tree.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..device import NP_DTYPES
from ..profiling import count, wait

#: layout: (tuple[(offset_words, shape, dtype_name)], treedef)
Layout = Tuple[tuple, Any]

_TORCH_DTYPES = {"float32": torch.float32, "int32": torch.int32, "uint32": torch.uint32}


def _flatten(tree, leaves: list):
    """Append `tree`'s leaves in jax.tree_util's order -> its structure
    (hashable): dicts by sorted key, tuples and lists in order, None a node
    with no leaf, anything else a leaf."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return ("dict", keys, tuple(_flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, (tuple, list)):
        kind = "tuple" if isinstance(tree, tuple) else "list"
        return (kind, tuple(_flatten(t, leaves) for t in tree))
    if tree is None:
        return ("none",)
    leaves.append(tree)
    return ("leaf",)


def tree_flatten(tree) -> tuple:
    """-> (leaves, treedef)."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def tree_unflatten(treedef, leaves):
    """Rebuild a tree of `treedef`'s structure from `leaves` (in order)."""
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        if kind == "tuple":
            return tuple(build(c) for c in d[1])
        if kind == "list":
            return [build(c) for c in d[1]]
        if kind == "none":
            return None
        return next(it)

    return build(treedef)


#: treedef -> (shapes, dtypes, offsets, total, layout). The engine loop packs
#: the same tree structure every frame through a new Rasterizer
#: (client.draw_d3 builds one a frame), so the cache is module-level;
#: bounded, cleared wholesale when it grows past 32 entries.
_PACK_CACHE: dict = {}


def pack_arena(tree) -> Tuple[Optional[np.ndarray], Optional[Layout]]:
    """Flatten `tree`'s numpy leaves into one uint32 buffer -> (buffer,
    layout), or (None, None) when a leaf is not 4 bytes wide or is already
    a tensor (its bits would have to come back from the device); the caller
    then uploads leaf by leaf, and the refusal is counted (`arena.refusal`)."""
    leaves, treedef = tree_flatten(tree)

    cached = _PACK_CACHE.get(treedef)
    if cached is not None:
        shapes, dtypes, offs, total, layout = cached
        arena = np.empty(max(total, 1), np.uint32)
        hit = len(leaves) == len(shapes)
        if hit:
            for i, x in enumerate(leaves):
                if isinstance(x, torch.Tensor):
                    hit = False
                    break
                a = x if isinstance(x, np.ndarray) else np.asarray(x)
                if a.shape != shapes[i] or a.dtype != dtypes[i]:
                    hit = False
                    break
                o = offs[i]
                arena[o:o + a.size] = a.reshape(-1).view(np.uint32)
        if hit:
            return arena, layout

    arrs = []
    for x in leaves:
        if isinstance(x, torch.Tensor):
            count("arena.refusal")
            return None, None
        a = np.asarray(x)
        if a.dtype.itemsize != 4:
            count("arena.refusal")
            return None, None
        arrs.append(a)

    total = sum(a.size for a in arrs)
    arena = np.empty(max(total, 1), np.uint32)
    entries = []
    off = 0
    for a in arrs:
        arena[off:off + a.size] = np.ascontiguousarray(a.reshape(-1)).view(np.uint32)
        entries.append((off, a.shape, a.dtype.name))
        off += a.size
    layout = (tuple(entries), treedef)
    if len(_PACK_CACHE) > 32:
        _PACK_CACHE.clear()
    _PACK_CACHE[treedef] = (tuple(a.shape for a in arrs), tuple(a.dtype for a in arrs),
                            tuple(e[0] for e in entries), total, layout)
    return arena, layout


def unpack_arena(arena: torch.Tensor, layout: Layout):
    """Rebuild the tree from the arena on the device (int32, as `upload`
    returns it): each leaf a view of its words, `narrow` + same-width
    `view(dtype)` + `reshape`. No copy."""
    entries, treedef = layout
    leaves = []
    for off, shape, dtype_name in entries:
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        leaves.append(arena.narrow(0, off, n).view(_TORCH_DTYPES[dtype_name]).reshape(shape))
    return tree_unflatten(treedef, leaves)


class _Staging:
    """Two pinned host buffers a device, used in turn. A buffer is refilled
    only after the event recorded behind its last non-blocking copy has
    passed, so the host never overwrites words a queued copy still reads."""

    def __init__(self):
        self.bufs = [None, None]
        self.events = [None, None]
        self.turn = 0


_STAGING: dict = {}


def upload(arena_np: np.ndarray, device) -> torch.Tensor:
    """The arena on `device` as an int32 tensor, in one host-to-device copy.
    On CUDA the words go through a pinned staging buffer and a non-blocking
    copy on the current stream; on the CPU the tensor shares the buffer.
    The host waits (`wait("staging")`) only where the copy that last read
    the staging buffer is still queued."""
    words = arena_np.view(np.int32)
    count("arena.upload")
    if device.type != "cuda":
        return torch.from_numpy(words)
    st = _STAGING.setdefault(device, _Staging())
    i = st.turn
    st.turn ^= 1
    if st.events[i] is not None and not st.events[i].query():
        with wait("staging"):
            st.events[i].synchronize()
    buf = st.bufs[i]
    n = words.size
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, 1024), dtype=torch.int32, pin_memory=True)
        st.bufs[i] = buf
    buf[:n].numpy()[:] = words
    out = torch.empty(n, dtype=torch.int32, device=device)
    out.copy_(buf[:n], non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    st.events[i] = ev
    return out


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """One numpy array (0-d kept 0-d) on `device`."""
    return torch.from_numpy(a if a.flags.c_contiguous else a.copy()).to(device)


def upload_leaves(tree, device):
    """The per-leaf route (the JAX package's batched device_put): every
    numpy leaf of `tree` copied to `device` on its own -> the same tree of
    tensors. Counted in `arena.leaf_frame`."""
    count("arena.leaf_frame")
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [_to_device(np.asarray(x), device) for x in leaves])


class Staged(dict):
    """A frame's host dict (the lights or the uniforms) whose leaves are
    also on the device, as views of the frame's arena (`dev`), with the
    packs derived from it on the host before the upload (`packs`, name ->
    device view). Item access gives the numpy leaf."""

    def __init__(self, host: dict, dev: dict, packs: dict = None):
        super().__init__(host)
        self.dev = dev
        self.packs = packs or {}


def leaf(d: dict, key, device, dtype=None) -> torch.Tensor:
    """d[key] as a tensor on `device`: the arena's view when `d` is Staged
    (cast on the device to `dtype` if given), else an upload of the numpy
    leaf (as `dtype` if given)."""
    dev = getattr(d, "dev", None)
    if dev is not None and key in dev:
        t = dev[key]
        return t if dtype is None or t.dtype == dtype else t.to(dtype)
    a = np.asarray(d[key])
    return _to_device(a if dtype is None else a.astype(NP_DTYPES[dtype], copy=False), device)


def staged_pack(d: dict, name: str, key=None) -> Optional[torch.Tensor]:
    """The derived pack `name` that came with `d` in the arena, when it was
    built for the same `key` (the arguments it was derived with), else None."""
    hit = getattr(d, "packs", {}).get(name)
    if hit is None or hit[0] != key:
        return None
    return hit[1]
