"""setup_s: process start to the end of set-up: imports, the kernels'
build check (the build itself in a checkout's first run), the scene, the
warm frames of the cell's traffic and any metric's `prepare`."""


def read(rd):
    return rd.setup_s
