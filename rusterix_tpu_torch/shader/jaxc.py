"""Stand-in for the rusteria compiler's array backend (see `..shader`)."""

from . import unported


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise unported(name)
