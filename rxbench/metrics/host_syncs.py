"""host_syncs: the port's `sync.*` counts a frame (profiling.counters: one
at each wait of the host on the device in Rasterizer.rasterize), in frames
rendered without the profiler (rxbench.lib.spans)."""

from rxbench.lib.spans import gather


def read(rd):
    spans = gather(rd)
    return None if spans is None else float(spans["host_syncs"])
