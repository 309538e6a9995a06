"""host_wait_ms: the host's ms a frame inside the port's `wait.*` spans
(where Rasterizer.rasterize blocks on the device: the 2D pass's lists, the
staging buffer, the readback), on the host's clock in frames rendered
without the profiler (rxbench.lib.spans)."""

from rxbench.lib.spans import gather


def read(rd):
    spans = gather(rd)
    return None if spans is None else spans["host_wait_ms"]
