"""b3_walk_roofline: the reflection rays' walk (csrc/rt_kernel.cu,
rt_kernel: B3's walk) against its bound, in %: the least time of the
profiled frames' walk (rxbench.lib.roofline.walk_bound_ms, from the
reference's counts of each frame's rays and the triangle boxes they cross)
over the walk's profiled device time a frame: its device time a launch
(robust to records the profiler lost) times the launches a frame (one a
reflection pass: the opaque frame's, and the opacity layer's where there
is one)."""

from rxbench.lib.roofline import walk_bound_ms
from rxbench.lib.trace import kernel_ms

KERNEL = "rt_kernel"


def read(rd):
    if rd.prof is None or not rd.work:
        return None
    ms, count = kernel_ms(rd.prof, KERNEL)
    if count == 0:
        return None
    bound = sum(walk_bound_ms(w) for w in rd.work) / len(rd.work)
    passes = sum(w["walk_passes"] for w in rd.work) / len(rd.work)
    return 100.0 * bound / (ms / count * passes)
