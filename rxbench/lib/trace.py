"""What the traced run reads: torch.profiler's device records of a few
frames, the host-to-device copies of a frame, and the host's wall a frame.

Copied from chip_smoke.py (profile_calls, is_kernel, HostCopies) so that
the yardstick lives with the benchmark."""

from __future__ import annotations

import collections
import re
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COPY_NAMES = ("Memcpy", "Memset")


def profile(fn, n: int) -> dict | None:
    """Device activity of `n` calls of `fn` under torch.profiler -> None
    when no device record was kept, else "events" (name, start us, end us)
    of the device, "window_us" (the host's time from the first call to the
    device's last work) and "busy_us" (the union of the device
    intervals)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    evs = prof.events()
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in evs
           if e.device_type == DeviceType.CUDA]
    if not dev:
        return None
    return {"events": dev, "window_us": window_us, "busy_us": union_us(dev), "calls": n}


def union_us(events) -> float:
    busy, reach = 0.0, float("-inf")
    for start, end in sorted((s, e) for _n, s, e in events):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def is_kernel(name: str, symbol: str) -> bool:
    """Does the profiler's kernel name denote the __global__ function
    `symbol` (demangled "symbol(...)" or "symbol<...>(...)", or mangled
    "_Z<len>symbol...")?"""
    name = name.removeprefix("void ")
    return name == symbol or name.startswith(
        (symbol + "(", symbol + "<", f"_Z{len(symbol)}{symbol}"))


def port_kernels(root: Path) -> set:
    """The names of the port's hand-written CUDA kernels: every __global__
    function in rusterix_tpu_torch/csrc."""
    names = set()
    for src in sorted((root / "rusterix_tpu_torch" / "csrc").glob("*.cu*")):
        text = src.read_text()
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                                text))
    return names


def kernel_ms(prof: dict, symbol: str) -> tuple:
    """(total device ms, records) of the kernel `symbol` in a profile."""
    ms, count = 0.0, 0
    for name, s, e in prof["events"]:
        if is_kernel(name, symbol):
            ms += (e - s) / 1e3
            count += 1
    return ms, count


def idle_gaps(prof: dict, top: int = 10) -> list:
    """The longest gaps between the device's busy intervals, each named by
    the device operation that ended last before it (the host was
    dispatching, or waiting, after it) -> [["after <op>", s]]."""
    iv = sorted((s, e, n) for n, s, e in prof["events"])
    gaps, reach, last = [], iv[0][1], iv[0][2]
    for s, e, n in iv[1:]:
        if s > reach:
            gaps.append((s - reach, last))
        if e >= reach:
            reach, last = e, n
    gaps.sort(key=lambda g: -g[0])
    return [["after " + name[:114], us / 1e6] for us, name in gaps[:top]]


def top_ops(prof: dict, top: int = 10) -> list:
    """The device operations that took most time -> [[name, s]]."""
    by = collections.Counter()
    for n, s, e in prof["events"]:
        by[n] += (e - s) / 1e6
    return [[n[:120], s] for n, s in by.most_common(top)]


class HostCopies(TorchDispatchMode):
    """A `with` block whose `ops` counts, by op, what PyTorch dispatches
    inside it that moves host data to the card: a copy from a host tensor
    into a card tensor, a tensor made on the card from host data
    (lift_fresh of its result), and any other op on the card that takes a
    host tensor of one or more dimensions; a 0-d host tensor elsewhere is a
    scalar argument (chip_smoke.HostCopies)."""

    COPIES = ("aten.copy_.default", "aten._to_copy.default", "aten._copy_from.default",
              "aten._copy_from_and_resize.default")

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(t.device.type != "cpu" for t in ins + outs):
            name = str(func)
            host = [t for t in ins if t.device.type == "cpu"]
            if ((name == "aten.lift_fresh.default" and outs[0].device.type != "cpu")
                    or any(t.dim() > 0 or name in self.COPIES for t in host)):
                self.ops[name] += 1
        return out
