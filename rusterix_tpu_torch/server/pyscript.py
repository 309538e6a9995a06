"""Python-dialect entity scripts — the reference minigame's .rxe format.

The reference once embedded RustPython for entity scripting; that engine is
commented out of the live code (src/server/region.rs:94-160) in favor of the
src/vm language, but the SHIPPED minigame assets still use the Python class
dialect (minigame/Player.rxe: `class Player:` with `event`/`user_event`
methods calling host builtins as bare globals). Per our broken-reference
convention we implement the documented intent: this runtime IS CPython, so
the dialect executes natively — the script is exec'd with the region host's
builtins bound as module globals, the script's class is instantiated per
entity, and methods dispatch exactly like their VM counterparts.

Host builtins bridge to the same RegionHost `h_*` handlers the VM uses
(server/region.py), with plain Python values converted to/from VMValue.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

from ..vm import VMValue

_CLASS_RE = re.compile(r"^\s*class\s+\w+\s*(\(|:)", re.M)


def looks_like_python_dialect(source: str) -> bool:
    """True when the script is a Python class script rather than the
    src/vm language (which has no `class`)."""
    return bool(_CLASS_RE.search(source))


def _to_vmvalue(x) -> VMValue:
    if isinstance(x, VMValue):
        return x
    if isinstance(x, str):
        return VMValue.from_string(x)
    if isinstance(x, bool):
        return VMValue.broadcast(1.0 if x else 0.0)
    if isinstance(x, (int, float)):
        return VMValue.broadcast(float(x))
    if x is None:
        return VMValue.zero()
    if isinstance(x, (tuple, list)) and len(x) == 3:
        return VMValue.vec(*[float(v) for v in x])
    return VMValue.from_string(str(x))


def _from_vmvalue(v):
    if not isinstance(v, VMValue):
        return v
    if v.s is not None:
        return v.s
    return v.x


class HostCallGlobals(dict):
    """exec globals for the Python dialect: every unknown bare name that is
    not a Python builtin resolves to a host-call bridge from the subclass's
    `_bridge(name)` hook. Builtins (str/int/len/print/...) must keep
    resolving normally: a dict subclass's __missing__ preempts the builtins
    fallback, so it raises KeyError for them. The generated closure is
    cached in the dict — per-tick event handlers re-look-up the same names
    every call, and the builtins scan + closure allocation is not free."""

    def __missing__(self, key):
        import builtins

        if key.startswith("__") or hasattr(builtins, key):
            raise KeyError(key)
        call = self._bridge(key)
        call.__name__ = key
        self[key] = call
        return call

    def _bridge(self, key):
        raise NotImplementedError


class _HostGlobals(HostCallGlobals):
    """Server-side bridge: host calls route through RegionHost.on_host_call —
    which records unknown names like the VM path (region.py on_host_call)
    instead of raising NameError mid-script."""

    def __init__(self, region):
        super().__init__()
        self.region = region

    def _bridge(self, key):
        region = self.region

        def call(*args):
            return _from_vmvalue(
                region.host.on_host_call(
                    key, [_to_vmvalue(a) for a in args], None
                )
            )

        return call


def exec_entity_class(source: str, ns: dict):
    """exec an .rxe script and return ``(class_name, class)`` — the first
    class the script DEFINES (the dialect's one-entity-class-per-file
    convention). Classes the script merely imports (``from enum import
    Enum``) are skipped by checking ``__module__`` against the exec
    namespace's module name. Returns ``("", None)`` when it defines no
    class."""
    ns.setdefault("__name__", "<rxe>")
    exec(compile(source, "<rxe>", "exec"), ns)
    for k, v in ns.items():
        if (
            isinstance(v, type)
            and not k.startswith("_")
            and getattr(v, "__module__", None) == ns["__name__"]
        ):
            return k, v
    return "", None


class PythonEntityProgram:
    """One compiled .rxe class script; instantiated per entity on first use."""

    def __init__(self, source: str, region):
        self.source = source
        self.region = region
        self.cls: Optional[type] = None
        self.class_name: str = ""
        #: parity with the VM Program surface: run_entity_event checks
        #: `"event" in program.functions`
        self.functions: Dict[str, bool] = {}
        self.instances: Dict[int, object] = {}
        self._compile()

    def _compile(self) -> None:
        ns = _HostGlobals(self.region)
        self.class_name, self.cls = exec_entity_class(self.source, ns)
        if self.cls is None:
            raise ValueError("python-dialect script defines no class")
        self.functions = {
            name: True
            for name in ("event", "user_event")
            if callable(getattr(self.cls, name, None))
        }

    def call(self, fn_name: str, entity_id: int, event: str, value) -> None:
        inst = self.instances.get(entity_id)
        if inst is None:
            inst = self.cls()
            self.instances[entity_id] = inst
        method = getattr(inst, fn_name, None)
        if method is None:
            return
        if isinstance(value, VMValue):
            value = _from_vmvalue(value)
        method(event, value)
