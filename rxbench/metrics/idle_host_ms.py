"""idle_host_ms: device-idle ms a frame, in the profiled frames, while the
host was inside the port's `frame` span (Rasterizer.rasterize) and outside
every `wait.*` span: the idle the host's own work in the frame causes
(rxbench.lib.spans)."""

from rxbench.lib.spans import gather


def read(rd):
    spans = gather(rd)
    return None if spans is None else spans["idle_host_ms"]
