"""rasterize_host_ms: the host's wall of one `rasterize(readback=False)`
call (ops/raster.py, Rasterizer.rasterize), averaged over the traced
window's frames, each timed from the call to its return with the device
idle at the call; a wait of the host inside the frame (composite.d2_lists)
is inside it."""


def read(rd):
    return sum(rd.host_ms) / len(rd.host_ms) if rd.host_ms else None
