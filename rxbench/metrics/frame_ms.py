"""frame_ms: the window's seconds x 1000 over the frames completed in it
(a closed loop, so every frame's time and every gap between frames is in
it)."""


def read(rd):
    return rd.window_s * 1e3 / rd.completed if rd.completed else None
