"""Client-side per-player script actions (reference src/client/action.rs).

The player's entity class script runs a `user_event(event, value)` handler on
the CLIENT for input (key presses etc.); `action(..)` / `intent(..)` host
calls from the script become the EntityAction the client sends to the server.
"""

from __future__ import annotations

from typing import Optional

from ..server.message import EntityAction, EntityActionKind
from ..server.pyscript import HostCallGlobals
from ..vm import VM, HostHandler, VMValue


class _ClientHostHandler(HostHandler):
    """action.rs:7-30 — captures action/intent calls."""

    def __init__(self):
        super().__init__()
        self.action: Optional[EntityAction] = None

    def on_host_call(self, name, args, vm):
        if name == "action" and args:
            s = args[0].as_string()
            if s is not None:
                parsed = EntityAction.from_str(s)
                if parsed is not None:
                    self.action = parsed
        elif name == "intent" and args:
            s = args[0].as_string()
            if s is not None:
                self.action = EntityAction(EntityActionKind.Intent, string=s)
        return VMValue.zero()


class _PyGlobals(HostCallGlobals):
    """Client-side bridge: host calls route through the owner's CURRENT
    handler (rebound per user_event call, so caching the closure is safe)."""

    def __init__(self, owner: "ClientAction"):
        super().__init__()
        self.owner = owner

    def _bridge(self, key):
        owner = self.owner

        def call(*args):
            from ..server.pyscript import _from_vmvalue, _to_vmvalue

            handler = owner._current_handler
            if handler is None:
                return None
            out = handler.on_host_call(
                key, [_to_vmvalue(a) for a in args], None
            )
            return _from_vmvalue(out)

        return call


class ClientAction:
    """action.rs:32-91."""

    def __init__(self):
        self.vm = VM()
        self.class_name = ""
        self._has_user_event = False
        #: Python-dialect script state (minigame .rxe format; see
        #: server/pyscript.py for the dialect rationale)
        self._py_inst = None
        self._current_handler: Optional[_ClientHostHandler] = None

    def init(self, class_name: str, assets) -> None:
        entry = assets.entities.get(class_name)
        if entry is None:
            return
        source = entry[0] if isinstance(entry, tuple) else entry
        from ..server.pyscript import looks_like_python_dialect

        if looks_like_python_dialect(source):
            try:
                from ..server.pyscript import exec_entity_class

                _, cls = exec_entity_class(source, _PyGlobals(self))
                if cls is None:
                    raise ValueError("python-dialect script defines no class")
                self._py_inst = cls()
                self._has_user_event = callable(
                    getattr(self._py_inst, "user_event", None)
                )
            except Exception as e:
                print(f"Client: error compiling user_event: {e}")
                return
            self.class_name = class_name
            return
        try:
            module = self.vm.parse_str(source)
            self.vm.compile(module)
            self._has_user_event = "user_event" in module.functions()
        except Exception as e:  # compile error -> action-less client
            print(f"Client: error compiling user_event: {e}")
            return
        self.class_name = class_name

    def user_event(self, event: str, value) -> EntityAction:
        """Run the script's user_event; return the captured action
        (action.rs:72-91)."""
        if not self._has_user_event:
            return EntityAction(EntityActionKind.Off)
        handler = _ClientHostHandler()
        if self._py_inst is not None:
            self._current_handler = handler
            try:
                if isinstance(value, VMValue):
                    value = value.s if value.s is not None else value.x
                self._py_inst.user_event(event, value)
            except Exception:
                return EntityAction(EntityActionKind.Off)
            finally:
                self._current_handler = None
            return handler.action or EntityAction(EntityActionKind.Off)
        if self.vm.program is None:
            return EntityAction(EntityActionKind.Off)
        ex = self.vm.new_execution(handler)
        if isinstance(value, VMValue):
            vm_value = value
        elif isinstance(value, str):
            vm_value = VMValue.from_string(value)
        elif isinstance(value, (int, float)):
            vm_value = VMValue.broadcast(float(value))
        else:
            vm_value = VMValue.zero()
        try:
            ex.execute_function([VMValue.from_string(event), vm_value], "user_event")
        except Exception:
            return EntityAction(EntityActionKind.Off)
        if handler.action is not None:
            return handler.action
        return EntityAction(EntityActionKind.Off)
