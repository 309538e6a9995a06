"""Stand-in for the rusteria shader compiler, which the port has not ported.

The host layer imports it lazily (`from ..shader import Rusteria`, and the
packer's `from ..shader.jaxc import Rusteria`) only when a scene carries
rusteria shaders; every name read here raises `NotImplementedError`. The
procedural pattern bank (`patterns`: the numpy bank and its torch sampler)
is ported; the sky's cloud layer samples it.
"""

import importlib

#: submodules of the package, importable by attribute as well
_SUBMODULES = ("jaxc", "patterns")


def unported(name: str):
    return NotImplementedError(
        f"rusteria shaders ({name}) need the rusteria shader compiler, which "
        "rusterix_tpu_torch has not ported yet"
    )


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise unported(name)
