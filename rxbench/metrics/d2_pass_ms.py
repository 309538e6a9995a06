"""d2_pass_ms: device ms a frame of the work launched inside the port's
`d2` span (ops/composite.py d2_pass, the 2D pass, with its lists' wait,
its lights and its steps), from the profiled frames
(rxbench.lib.spans)."""

from rxbench.lib.spans import gather


def read(rd):
    spans = gather(rd)
    return None if spans is None else spans["d2_pass_ms"]
