"""Entity-script VM — host interpreter.

reference: src/vm/ (the rusteria fork generalized to `VMValue` = Vec3 +
optional string payload, with HostCall ops routed to a `HostHandler`,
src/vm/node/hosthandler.rs:4-28). Entity logic is branchy and low-rate
(ticks, not pixels), so the TPU build runs it as a host tree-walking
interpreter over the shared language AST (lang/), exactly mirroring the
reference's scalar execution semantics (src/vm/mod.rs tests are the spec).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from ..lang import ast as A
from ..lang.parser import parse


@dataclass
class VMValue:
    """Vec3 + optional string (src/vm/value.rs:6)."""

    v: np.ndarray  # (3,) float32
    s: Optional[str] = None

    @staticmethod
    def broadcast(x: float) -> "VMValue":
        return VMValue(np.full(3, float(x), np.float32))

    @staticmethod
    def vec(x, y, z) -> "VMValue":
        return VMValue(np.array([x, y, z], np.float32))

    @staticmethod
    def from_string(s: str) -> "VMValue":
        return VMValue(np.zeros(3, np.float32), s)

    @staticmethod
    def zero() -> "VMValue":
        return VMValue(np.zeros(3, np.float32))

    @property
    def x(self) -> float:
        return float(self.v[0])

    def as_string(self) -> Optional[str]:
        return self.s

    def display(self) -> str:
        if self.s is not None:
            return self.s
        x, y, z = self.v
        if x == y == z:
            return f"{x:g}"
        return f"({x:g}, {y:g}, {z:g})"

    def truthy(self) -> bool:
        if self.s is not None:
            return len(self.s) > 0
        return self.x != 0.0


class HostHandler:
    """Seam for host calls (src/vm/node/hosthandler.rs). Override on_host_call;
    outputs are captured like the reference's `exec.outputs`."""

    def __init__(self):
        self.outputs: Dict[str, VMValue] = {}

    def on_host_call(self, name: str, args: List[VMValue], vm: "Execution") -> VMValue:
        self.outputs[name] = args[0] if args else VMValue.zero()
        return VMValue.zero()


class _Return(Exception):
    def __init__(self, value: VMValue):
        self.value = value


class _Break(Exception):
    pass


REGISTERS = (
    "uv", "color", "roughness", "metallic", "emissive", "opacity", "bump",
    "normal", "hitpoint", "time",
)


class Execution:
    """Interpreter state: globals + registers + host seam."""

    def __init__(self, program: "VMProgram", host: Optional[HostHandler] = None):
        self.program = program
        self.host = host or HostHandler()
        self.globals: Dict[str, VMValue] = {}
        self.registers: Dict[str, VMValue] = {r: VMValue.zero() for r in REGISTERS}
        self.last_value: Optional[VMValue] = None
        self.prints: List[str] = []
        self.depth = 0

    @property
    def outputs(self) -> Dict[str, VMValue]:
        return self.host.outputs

    def reset(self, _globals_len=None) -> None:
        self.globals = {}
        self.last_value = None

    # ---- execution ----

    def run_module(self) -> VMValue:
        """Execute top-level statements; return the last expression value
        (VM::execute_string semantics)."""
        for s in self.program.module.stmts:
            if isinstance(s, A.FnDef):
                continue
            self.exec_stmt(s, self.globals)
        return self.last_value if self.last_value is not None else VMValue.zero()

    def execute_function(self, args: List[VMValue], name_or_index, program=None) -> VMValue:
        fns = self.program.functions
        if isinstance(name_or_index, int):
            fn = list(fns.values())[name_or_index]
        else:
            fn = fns[name_or_index]
        return self.call_user(fn, list(args))

    def call_user(self, fn: A.FnDef, args: List[VMValue]) -> VMValue:
        if self.depth > 200:
            raise RecursionError(f"script recursion too deep in {fn.name}")
        self.depth += 1
        env = {p: (args[i] if i < len(args) else VMValue.zero()) for i, p in enumerate(fn.params)}
        try:
            for s in fn.body:
                self.exec_stmt(s, env)
        except _Return as r:
            return r.value
        finally:
            self.depth -= 1
        return self.last_value if self.last_value is not None else VMValue.zero()

    # ---- statements ----

    def exec_stmt(self, s, env: Dict[str, VMValue]) -> None:
        if isinstance(s, A.Let):
            env[s.name] = self.eval(s.value, env)
        elif isinstance(s, A.Assign):
            self.exec_assign(s, env)
        elif isinstance(s, A.ExprStmt):
            self.last_value = self.eval(s.expr, env)
        elif isinstance(s, A.If):
            if self.eval(s.cond, env).truthy():
                self.exec_block(s.then, env)
            elif s.other is not None:
                self.exec_block(s.other, env)
        elif isinstance(s, A.For):
            local = dict(env)
            for st in s.init:
                self.exec_stmt(st, local)
            guard = 0
            while self.eval(s.cond, local).truthy():
                try:
                    self.exec_block(s.body, local)
                except _Break:
                    break
                for st in s.incr:
                    self.exec_stmt(st, local)
                guard += 1
                if guard > 10_000_000:
                    raise RuntimeError("infinite for loop detected")
            # propagate writes to pre-existing names
            for k in env:
                env[k] = local[k]
        elif isinstance(s, A.While):
            guard = 0
            while self.eval(s.cond, env).truthy():
                try:
                    self.exec_block(s.body, env)
                except _Break:
                    break
                guard += 1
                if guard > 10_000_000:
                    raise RuntimeError("infinite while loop detected")
        elif isinstance(s, A.Return):
            raise _Return(
                self.eval(s.value, env) if s.value is not None else VMValue.zero()
            )
        elif isinstance(s, A.Break):
            raise _Break()
        elif isinstance(s, A.Match):
            self.exec_match(s, env)
        elif isinstance(s, A.FnDef):
            pass
        else:
            raise RuntimeError(f"unsupported statement {type(s).__name__}")

    def exec_block(self, stmts, env) -> None:
        local = dict(env)
        try:
            for s in stmts:
                self.exec_stmt(s, local)
        finally:
            # propagate writes to pre-existing names even through break/return
            for k in env:
                env[k] = local[k]

    def exec_match(self, s: A.Match, env) -> None:
        """match with string/number patterns and `_` default
        (src/vm/mod.rs:250-307)."""
        subject = self.eval(s.subject, env)
        for pattern, body in s.arms:
            if pattern is None:
                self.exec_block(body, env)
                return
            pv = self.eval(pattern, env)
            if _values_equal(subject, pv):
                self.exec_block(body, env)
                return

    def exec_assign(self, s: A.Assign, env) -> None:
        val = self.eval(s.value, env)
        if isinstance(s.target, A.Ident):
            name = s.target.name
            if s.op != "=":
                cur = self.lookup(name, env)
                val = _binop(s.op[0], cur, val)
            if name in env:
                env[name] = val
            elif name in self.registers:
                self.registers[name] = val
            else:
                self.globals[name] = val
        elif isinstance(s.target, A.Swizzle) and isinstance(s.target.base, A.Ident):
            name = s.target.base.name
            cur = self.lookup(name, env)
            comps = s.target.components
            if s.op != "=":
                sub = _swizzle(cur, comps)
                val = _binop(s.op[0], sub, val)
            out = VMValue(cur.v.copy(), cur.s)
            for i, c in enumerate(comps):
                out.v[c] = val.v[min(i, 2)]
            if name in env:
                env[name] = out
            elif name in self.registers:
                self.registers[name] = out
            else:
                self.globals[name] = out
        else:
            raise RuntimeError("bad assignment target")

    def lookup(self, name: str, env) -> VMValue:
        if name in env:
            return env[name]
        if name in self.registers:
            return self.registers[name]
        if name in self.globals:
            return self.globals[name]
        raise NameError(f"unknown identifier {name}")

    # ---- expressions ----

    def eval(self, e, env) -> VMValue:
        if isinstance(e, A.Num):
            return VMValue.broadcast(e.value)
        if isinstance(e, A.Str):
            return VMValue.from_string(e.value)
        if isinstance(e, A.Ident):
            return self.lookup(e.name, env)
        if isinstance(e, A.Swizzle):
            return _swizzle(self.eval(e.base, env), e.components)
        if isinstance(e, A.Unary):
            v = self.eval(e.operand, env)
            if e.op == "-":
                return VMValue(-v.v)
            return VMValue.broadcast(0.0 if v.truthy() else 1.0)
        if isinstance(e, A.Binary):
            return _binop(e.op, self.eval(e.left, env), self.eval(e.right, env))
        if isinstance(e, A.Ternary):
            return (
                self.eval(e.then, env)
                if self.eval(e.cond, env).truthy()
                else self.eval(e.other, env)
            )
        if isinstance(e, A.Call):
            return self.call(e, env)
        raise RuntimeError(f"unsupported expression {type(e).__name__}")

    def call(self, e: A.Call, env) -> VMValue:
        if e.name in self.program.functions:
            args = [self.eval(a, env) for a in e.args]
            return self.call_user(self.program.functions[e.name], args)
        builtin = _BUILTINS.get(e.name)
        if builtin is not None:
            args = [self.eval(a, env) for a in e.args]
            return builtin(self, args)
        # unknown function -> host call (src/vm HostCall)
        args = [self.eval(a, env) for a in e.args]
        return self.host.on_host_call(e.name, args, self)


# ---- value ops (src/vm execution semantics) ----


def _values_equal(a: VMValue, b: VMValue) -> bool:
    if a.s is not None or b.s is not None:
        return a.s == b.s
    return a.x == b.x


def _swizzle(v: VMValue, comps) -> VMValue:
    if len(comps) == 1:
        return VMValue.broadcast(float(v.v[comps[0]]))
    out = np.zeros(3, np.float32)
    for i, c in enumerate(comps):
        out[i] = v.v[c]
    return VMValue(out)


def _binop(op: str, a: VMValue, b: VMValue) -> VMValue:
    if op == "+":
        if a.s is not None or b.s is not None:
            return VMValue.from_string(a.display() + b.display())
        return VMValue(a.v + b.v)
    if op == "-":
        return VMValue(a.v - b.v)
    if op == "*":
        return VMValue(a.v * b.v)
    if op == "/":
        with np.errstate(divide="ignore", invalid="ignore"):
            return VMValue(a.v / b.v)
    if op == "%":
        with np.errstate(divide="ignore", invalid="ignore"):
            return VMValue(a.v - b.v * np.floor(a.v / b.v))
    if op == "==":
        return VMValue.broadcast(1.0 if _values_equal(a, b) else 0.0)
    if op == "!=":
        return VMValue.broadcast(0.0 if _values_equal(a, b) else 1.0)
    if op == "<":
        return VMValue.broadcast(1.0 if a.x < b.x else 0.0)
    if op == "<=":
        return VMValue.broadcast(1.0 if a.x <= b.x else 0.0)
    if op == ">":
        return VMValue.broadcast(1.0 if a.x > b.x else 0.0)
    if op == ">=":
        return VMValue.broadcast(1.0 if a.x >= b.x else 0.0)
    if op == "&&":
        return VMValue.broadcast(1.0 if a.truthy() and b.truthy() else 0.0)
    if op == "||":
        return VMValue.broadcast(1.0 if a.truthy() or b.truthy() else 0.0)
    raise RuntimeError(f"unknown operator {op}")


def _cw(f: Callable[[np.ndarray], np.ndarray]):
    def run(vm, args):
        return VMValue(np.asarray(f(args[0].v), np.float32))

    return run


def _format_impl(vm: "Execution", args: List[VMValue]) -> VMValue:
    """format("a {} b", x, y) (src/vm/mod.rs:309-317)."""
    if not args or args[0].s is None:
        return VMValue.zero()
    out = []
    parts = args[0].s.split("{}")
    for i, part in enumerate(parts):
        out.append(part)
        if i + 1 < len(parts):
            out.append(args[i + 1].display() if i + 1 < len(args) else "{}")
    return VMValue.from_string("".join(out))


def _print_impl(vm: "Execution", args: List[VMValue]) -> VMValue:
    text = " ".join(a.display() for a in args)
    vm.prints.append(text)
    return VMValue.zero()


def _rotate2d_vm(args):
    v = args[0].v
    rad = float(np.radians(args[1].x))
    s, c = np.sin(rad), np.cos(rad)
    return VMValue.vec(
        float(v[0] * c - v[1] * s), float(v[0] * s + v[1] * c), float(v[2])
    )


_BUILTINS: Dict[str, Callable] = {
    "abs": _cw(np.abs),
    "sin": _cw(np.sin),
    "cos": _cw(np.cos),
    "tan": _cw(np.tan),
    "atan": _cw(np.arctan),
    "floor": _cw(np.floor),
    "ceil": _cw(np.ceil),
    "round": _cw(lambda x: np.sign(x) * np.floor(np.abs(x) + 0.5)),
    "fract": _cw(lambda x: x - np.floor(x)),
    "sqrt": _cw(np.sqrt),
    "log": _cw(np.log),
    "degrees": _cw(np.degrees),
    "radians": _cw(np.radians),
    "normalize": _cw(lambda x: x / max(float(np.linalg.norm(x)), 1e-30)),
    "format": _format_impl,
    "print": _print_impl,
}


def _two(f):
    def run(vm, args):
        return VMValue(np.asarray(f(args[0].v, args[1].v), np.float32))

    return run


_BUILTINS.update(
    {
        "min": _two(np.minimum),
        "max": _two(np.maximum),
        "pow": _two(np.power),
        "mod": _two(lambda a, b: a - b * np.floor(a / b)),
        "atan2": _two(np.arctan2),
        "cross": _two(np.cross),
        "dot": lambda vm, args: VMValue.broadcast(
            float(np.dot(args[0].v, args[1].v))
        ),
        "length": lambda vm, args: VMValue.broadcast(
            float(np.linalg.norm(args[0].v))
        ),
        # arity-suffixed variants (vm/builtin.rs:34-50): the plain forms act
        # componentwise/3D, the Nd forms read exactly N lanes and return a
        # scalar-in-x value (execution.rs:262-340)
        "length2": lambda vm, args: VMValue.vec(
            float(np.linalg.norm(args[0].v[:2])), 0.0, 0.0
        ),
        "length3": lambda vm, args: VMValue.vec(
            float(np.linalg.norm(args[0].v[:3])), 0.0, 0.0
        ),
        "dot2": lambda vm, args: VMValue.vec(
            float(np.dot(args[0].v[:2], args[1].v[:2])), 0.0, 0.0
        ),
        "dot3": lambda vm, args: VMValue.vec(
            float(np.dot(args[0].v[:3], args[1].v[:3])), 0.0, 0.0
        ),
        "sin1": lambda vm, args: VMValue.vec(float(np.sin(args[0].x)), 0.0, 0.0),
        "sin2": lambda vm, args: VMValue.vec(
            float(np.sin(args[0].v[0])), float(np.sin(args[0].v[1])), 0.0
        ),
        "cos1": lambda vm, args: VMValue.vec(float(np.cos(args[0].x)), 0.0, 0.0),
        "cos2": lambda vm, args: VMValue.vec(
            float(np.cos(args[0].v[0])), float(np.cos(args[0].v[1])), 0.0
        ),
        # rotate2d(v, angle_degrees) — execution.rs:322-329
        "rotate2d": lambda vm, args: _rotate2d_vm(args),
        "mix": lambda vm, args: VMValue(
            args[0].v + (args[1].v - args[0].v) * args[2].v
        ),
        "clamp": lambda vm, args: VMValue(
            np.clip(args[0].v, args[1].v, args[2].v)
        ),
        "step": lambda vm, args: VMValue(
            (args[1].v >= args[0].v).astype(np.float32)
        ),
        "smoothstep": lambda vm, args: _smoothstep_vm(args),
        "vec2": lambda vm, args: VMValue.vec(
            args[0].x, args[1].x if len(args) > 1 else args[0].x, 0.0
        ),
        "vec3": lambda vm, args: VMValue.vec(
            args[0].x,
            args[1].x if len(args) > 1 else args[0].x,
            args[2].x if len(args) > 2 else args[0].x,
        ),
    }
)


def _smoothstep_vm(args):
    e0, e1, x = args[0].x, args[1].x, args[2].x
    denom = e1 - e0
    t = (x - e0) / denom if denom != 0.0 else 0.0
    t = min(1.0, max(0.0, t))
    return VMValue.broadcast(t * t * (3.0 - 2.0 * t))


class VMProgram:
    def __init__(self, module: A.Module):
        self.module = module
        self.functions = module.functions()
        self.user_functions_name_map = {
            name: i for i, name in enumerate(self.functions)
        }


class VM:
    """Facade matching the reference (src/vm/mod.rs:42)."""

    def __init__(self):
        self.program: Optional[VMProgram] = None

    def parse_str(self, src: str) -> A.Module:
        return parse(src)

    def compile(self, module: A.Module) -> VMProgram:
        self.program = VMProgram(module)
        return self.program

    def execute_string(self, src: str, palette=None, host: Optional[HostHandler] = None) -> VMValue:
        self.compile(self.parse_str(src))
        ex = Execution(self.program, host)
        return ex.run_module()

    def new_execution(self, host: Optional[HostHandler] = None) -> Execution:
        return Execution(self.program, host)
