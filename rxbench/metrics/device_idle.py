"""device_idle: the share of the traced window (the profiled frames, from
the first call to the device's last work) in which no operation ran on
the card: one minus the union of torch.profiler's device intervals over
the window, in %."""


def read(rd):
    if rd.prof is None:
        return None
    return 100.0 * (1.0 - rd.prof["busy_us"] / rd.prof["window_us"])
