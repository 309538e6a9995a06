"""h2d_copies: the host-to-device copies of one steady frame, counted
where PyTorch dispatches them (rxbench.lib.trace.HostCopies): the
arena's upload (ops/arena.py) and any other."""


def read(rd):
    return None if rd.copies is None else float(rd.copies)
