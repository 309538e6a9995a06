"""b1_roofline: the opaque frame's megakernel (csrc/megakernel.cu,
mega_kernel: B1) against its bound, in %: the least time of the profiled
frames' B1 work (rxbench.lib.roofline.b1_bound_ms, from the reference's
counts of each frame) over B1's profiled device time a launch."""

from rxbench.lib.roofline import b1_bound_ms
from rxbench.lib.trace import kernel_ms

KERNEL = "mega_kernel"


def read(rd):
    if rd.prof is None or not rd.work:
        return None
    ms, count = kernel_ms(rd.prof, KERNEL)
    if count == 0:
        return None
    bound = sum(b1_bound_ms(w, w["light_types"], w["sun"]) for w in rd.work) / len(rd.work)
    return 100.0 * bound / (ms / count)
