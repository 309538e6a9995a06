"""reflect_ms: device ms a frame of the work launched inside every
`reflect` span of the port (ops/reflect.py's reflection passes, B3's
preparation and walk included: the opaque frame's and the peeled
layer's), from the profiled frames (rxbench.lib.spans)."""

from rxbench.lib.spans import gather


def read(rd):
    spans = gather(rd)
    return None if spans is None else spans["reflect_ms"]
