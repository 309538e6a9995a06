"""rusteria -> torch evaluator (the port's counterpart of the JAX package's
`rusterix_tpu/shader/jaxc.py`, kept under the same module name because the
host copies import it so).

The reference compiles shader source to stack bytecode interpreted per pixel
(rusteria/src/compile.rs -> node/execution.rs). Here, as in the JAX package,
the AST is traced into array operations over the whole pixel grid: eager
torch operations on the state's device, where the JAX package traces jnp
operations into a jitted program. Control flow vectorizes with active-lane
masks (if/return) and static unrolling (for loops with literal trip counts).

Value model (reference rusteria/src/lib.rs:17 `Value = Vec3<f32>`): every
value is a tensor shaped (..., 3); scalars are broadcast. A static `width`
tag (1/2/3) mirrors the reference compiler's type inference that selects
Dot2/Dot3/Length2/... variants. Comparison/logical results use the .x lane
(execution.rs:512-560).

Every value is concrete in torch. Where the JAX package ran a program
inside `jax.jit` (the bakes, `shade_image`, a texture script's `iterate`),
its branch conditions were traced and every `if` ran both arms under lane
masks; outside jit (`Program.run`, a texture script's top level) a uniform
condition took its branch alone. The evaluator keeps those decisions: an
Evaluator made with `traced=True` runs every `if` masked, as the jitted
programs did.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..lang import ast as A
from ..lang.parser import ParseError, parse
from .patterns import PATTERN_NAMES, pattern_bank, sample_pattern_jnp

REGISTER_WIDTHS = {
    "uv": 2,
    "color": 3,
    "roughness": 1,
    "metallic": 1,
    "emissive": 3,
    "opacity": 1,
    "bump": 1,
    "normal": 3,
    "hitpoint": 3,
    "time": 3,
}

MAX_RECURSION = 24
MAX_DYNAMIC_ITERS = 64


class CompileError(Exception):
    pass


@dataclass
class Val:
    arr: object  # f32 tensor (..., 3)
    width: int = 1

    @property
    def x(self):
        return self.arr[..., 0]


def _f32(x, device) -> torch.Tensor:
    """A number or a list of numbers as an f32 tensor (JAX's f32 constant)."""
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _broadcast(x, device) -> Val:
    a = _f32(x, device)
    return Val(torch.stack([a, a, a], dim=-1), 1)


def _mask_of(v: Val):
    return v.arr[..., 0] != 0.0


def _stack3(c) -> torch.Tensor:
    return torch.stack([c, c, c], dim=-1)


class Evaluator:
    """AST tracer. One instance per shade/run invocation.

    `device`: where the values live (default: that of the state's
    tensors). `traced`: run every `if` under lane masks, as the JAX
    package's jitted programs did (see the module docstring)."""

    def __init__(self, program: "Program", state: Dict, palette=None, host=None,
                 device=None, traced: bool = False):
        self.program = program
        self.state = state  # registers: name -> tensor (..., 3)
        self.palette = palette
        self.host = host  # optional host-call handler (unused for shaders)
        if device is None:
            found = [v.device for v in state.values() if torch.is_tensor(v)]
            if not found:
                raise ValueError("Evaluator: no device given and no state tensor to take it from")
            device = found[0]
        self.device = torch.device(device)
        self.traced = traced
        self.scopes: List[Dict[str, Val]] = [{}]  # globals at [0]
        self.active = None  # None = all lanes live, else bool tensor
        self.depth = 0
        self.last_value: Optional[Val] = None
        #: host-mode texture script state (alloc/iterate/save,
        #: execution.rs:656-741); only touched by Rusteria.execute_script
        self.textures: List[np.ndarray] = []
        self.saved: Dict[str, np.ndarray] = {}
        self.save_dir: Optional[str] = None

    def _bc(self, x) -> Val:
        return _broadcast(x, self.device)

    # ---- env ----

    def lookup(self, name: str) -> Optional[Val]:
        for scope in reversed(self.scopes):
            if name in scope:
                return scope[name]
        if name in self.state:
            return Val(self.state[name], REGISTER_WIDTHS.get(name, 3))
        return None

    def assign_name(self, name: str, val: Val):
        for scope in reversed(self.scopes):
            if name in scope:
                old = scope[name]
                scope[name] = self._merge(old, val)
                return
        if name in self.state:
            merged = self._merge(Val(self.state[name], val.width), val)
            self.state[name] = merged.arr
            return
        # implicit creation in current scope
        self.scopes[-1][name] = val

    def _merge(self, old: Val, new: Val) -> Val:
        if self.active is None or self.active is True:
            return new
        if self.active is False:
            return old
        m = self.active[..., None]
        return Val(torch.where(m, new.arr, old.arr), new.width)

    # ---- statements ----

    def exec_block(self, stmts, new_scope: bool = True):
        if new_scope:
            self.scopes.append({})
        try:
            for s in stmts:
                self.exec_stmt(s)
        finally:
            if new_scope:
                self.scopes.pop()

    def exec_stmt(self, s):
        if self.active is False:
            return  # all lanes returned — dead code
        if isinstance(s, A.Let):
            self.scopes[-1][s.name] = self.eval(s.value)
        elif isinstance(s, A.Assign):
            self.exec_assign(s)
        elif isinstance(s, A.ExprStmt):
            self.last_value = self.eval(s.expr)
        elif isinstance(s, A.If):
            self.exec_if(s)
        elif isinstance(s, A.For):
            self.exec_for(s)
        elif isinstance(s, A.While):
            self.exec_while(s)
        elif isinstance(s, A.Return):
            v = self.eval(s.value) if s.value is not None else self._bc(0.0)
            if self.active is None or self.active is True:
                self.ret_val = v
                self.ret_mask = True
                self.active = False
            elif self.active is False:
                pass  # dead code after a full return
            else:
                if self.ret_val is None:
                    self.ret_val = v
                    self.ret_mask = self.active
                else:
                    self.ret_val = Val(
                        torch.where(self.active[..., None], v.arr, self.ret_val.arr),
                        max(v.width, self.ret_val.width),
                    )
                    self.ret_mask = torch.logical_or(self.ret_mask, self.active)
                self.active = torch.zeros_like(self.active)
        elif isinstance(s, A.Match):
            self.exec_match(s)
        elif isinstance(s, A.FnDef):
            pass  # functions collected at program build
        elif isinstance(s, A.Break):
            raise CompileError("break is not supported in vectorized shaders")
        else:
            raise CompileError(f"unsupported statement {type(s).__name__}")

    def exec_assign(self, s: A.Assign):
        new = self.eval(s.value)
        if isinstance(s.target, A.Ident):
            name = s.target.name
            if s.op != "=":
                cur = self.lookup(name)
                if cur is None:
                    raise CompileError(f"unknown variable {name}")
                new = self._binop(s.op[0], cur, new)
            else:
                cur = self.lookup(name)
                if cur is not None:
                    new = Val(new.arr, new.width)
            self.assign_name(name, new)
        elif isinstance(s.target, A.Swizzle) and isinstance(s.target.base, A.Ident):
            name = s.target.base.name
            cur = self.lookup(name)
            if cur is None:
                raise CompileError(f"unknown variable {name}")
            comps = s.target.components
            if s.op != "=":
                cur_sub = self._swizzle(cur, comps)
                new = self._binop(s.op[0], cur_sub, new)
            # SetComponents semantics (execution.rs:158-182); the target may
            # need promotion from uniform to per-pixel shape first
            shape = torch.broadcast_shapes(cur.arr.shape, new.arr.shape)
            arr = torch.broadcast_to(cur.arr, shape).clone()
            for i, ci in enumerate(comps):
                arr[..., ci] = torch.broadcast_to(new.arr[..., min(i, 2)], shape[:-1])
            self.assign_name(name, Val(arr, cur.width))
        else:
            raise CompileError("unsupported assignment target")

    def _concrete_bool(self, m):
        """bool(m) when m is a uniform scalar outside a traced program, else
        None.

        Lets recursive functions (fib) terminate when run outside the
        traced contexts — the taken branch alone executes, like the
        reference's scalar interpreter. In a traced program (the JAX
        package's jit) every condition is a lane mask."""
        if self.traced:
            return None
        if m.numel() == 1:
            return bool(m.reshape(()))
        return None

    def exec_if(self, s: A.If):
        cond = _mask_of(self.eval(s.cond))
        if self.active is None or self.active is True:
            cb = self._concrete_bool(cond)
            if cb is not None:
                if cb:
                    self.exec_block(s.then)
                elif s.other is not None:
                    self.exec_block(s.other)
                return
        saved = self.active
        self.active = cond if saved is None else saved & cond
        self.exec_block(s.then)
        self.active = (~cond) if saved is None else saved & (~cond)
        if s.other is not None:
            self.exec_block(s.other)
        self.active = saved

    def exec_match(self, s: A.Match):
        """match with string/num patterns -> chained if/else on equality."""
        subject = self.eval(s.subject)
        saved = self.active
        taken = None
        for pattern, body in s.arms:
            if pattern is None:
                cond = torch.ones((), dtype=torch.bool, device=self.device) if taken is None \
                    else ~taken
                m = cond
            else:
                pv = self.eval(pattern)
                m = subject.arr[..., 0] == pv.arr[..., 0]
                if taken is not None:
                    m = m & ~taken
            taken = m if taken is None else (taken | m)
            self.active = m if saved is None else saved & m
            self.exec_block(body)
        self.active = saved

    def _static_float(self, expr, env: Dict[str, float]) -> Optional[float]:
        """Best-effort constant fold for loop bounds."""
        if isinstance(expr, A.Num):
            return expr.value
        if isinstance(expr, A.Ident) and expr.name in env:
            return env[expr.name]
        if isinstance(expr, A.Unary) and expr.op == "-":
            v = self._static_float(expr.operand, env)
            return None if v is None else -v
        if isinstance(expr, A.Binary):
            a = self._static_float(expr.left, env)
            b = self._static_float(expr.right, env)
            if a is None or b is None:
                return None
            return {
                "+": lambda: a + b,
                "-": lambda: a - b,
                "*": lambda: a * b,
                "/": lambda: a / b if b != 0 else None,
                "%": lambda: a - b * np.floor(a / b) if b != 0 else None,
                "<": lambda: float(a < b),
                "<=": lambda: float(a <= b),
                ">": lambda: float(a > b),
                ">=": lambda: float(a >= b),
                "==": lambda: float(a == b),
                "!=": lambda: float(a != b),
            }.get(expr.op, lambda: None)()
        return None

    def exec_for(self, s: A.For):
        # try static unroll: `for (let i = C0; i < C1; i += C2)`
        static_env: Dict[str, float] = {}
        loop_var = None
        if len(s.init) == 1 and isinstance(s.init[0], A.Let):
            c0 = self._static_float(s.init[0].value, {})
            if c0 is not None:
                loop_var = s.init[0].name
                static_env[loop_var] = c0

        if loop_var is not None:
            iters = []
            guard = 0
            env = dict(static_env)
            while True:
                c = self._static_float(s.cond, env)
                if c is None:
                    loop_var = None
                    break
                if c == 0.0:
                    break
                iters.append(env[loop_var])
                # apply increment statically
                ok = False
                if len(s.incr) == 1 and isinstance(s.incr[0], A.Assign):
                    inc = s.incr[0]
                    if isinstance(inc.target, A.Ident) and inc.target.name == loop_var:
                        delta = self._static_float(inc.value, env)
                        if delta is not None:
                            if inc.op == "+=":
                                env[loop_var] += delta
                                ok = True
                            elif inc.op == "-=":
                                env[loop_var] -= delta
                                ok = True
                            elif inc.op == "=":
                                env[loop_var] = delta
                                ok = True
                            elif inc.op == "*=":
                                env[loop_var] *= delta
                                ok = True
                if not ok:
                    loop_var = None
                    break
                guard += 1
                if guard > 65536:
                    raise CompileError("for loop exceeds unroll limit")
            if loop_var is not None:
                self.scopes.append({})
                try:
                    for it in iters:
                        self.scopes[-1][loop_var] = self._bc(it)
                        self.exec_block(s.body)
                finally:
                    self.scopes.pop()
                return

        # dynamic fallback: fixed-cap masked iterations
        self.scopes.append({})
        try:
            self.exec_block(s.init, new_scope=False)
            saved = self.active
            for _ in range(MAX_DYNAMIC_ITERS):
                cond = _mask_of(self.eval(s.cond))
                self.active = cond if saved is None else saved & cond
                self.exec_block(s.body)
                self.exec_block(s.incr, new_scope=False)
            self.active = saved
        finally:
            self.scopes.pop()

    def exec_while(self, s: A.While):
        saved = self.active
        for _ in range(MAX_DYNAMIC_ITERS):
            cond = _mask_of(self.eval(s.cond))
            self.active = cond if saved is None else saved & cond
            self.exec_block(s.body)
        self.active = saved

    # ---- expressions ----

    def eval(self, e) -> Val:
        if isinstance(e, A.Num):
            return self._bc(e.value)
        if isinstance(e, A.Str):
            raise CompileError("strings are host-VM only (entity scripts)")
        if isinstance(e, A.Ident):
            v = self.lookup(e.name)
            if v is None:
                raise CompileError(f"unknown identifier {e.name}")
            return v
        if isinstance(e, A.Swizzle):
            return self._swizzle(self.eval(e.base), e.components)
        if isinstance(e, A.Unary):
            v = self.eval(e.operand)
            if e.op == "-":
                return Val(-v.arr, v.width)
            return Val(
                torch.where((v.arr[..., 0] == 0.0)[..., None], self._bc(1.0).arr,
                            self._bc(0.0).arr),
                1,
            )
        if isinstance(e, A.Binary):
            return self._binop(e.op, self.eval(e.left), self.eval(e.right))
        if isinstance(e, A.Ternary):
            c = _mask_of(self.eval(e.cond))
            a = self.eval(e.then)
            b = self.eval(e.other)
            return Val(torch.where(c[..., None], a.arr, b.arr), max(a.width, b.width))
        if isinstance(e, A.Call):
            return self.call(e)
        raise CompileError(f"unsupported expression {type(e).__name__}")

    def _swizzle(self, v: Val, comps) -> Val:
        """GetComponents (execution.rs:134-157): 1 comp -> broadcast."""
        if len(comps) == 1:
            return Val(_stack3(v.arr[..., comps[0]]), 1)
        parts = [v.arr[..., c] for c in comps]
        while len(parts) < 3:
            parts.append(torch.zeros_like(parts[0]))
        return Val(torch.stack(parts[:3], dim=-1), len(comps))

    def _binop(self, op, a: Val, b: Val) -> Val:
        w = max(a.width, b.width)
        x, y = a.arr, b.arr
        if op == "+":
            return Val(x + y, w)
        if op == "-":
            return Val(x - y, w)
        if op == "*":
            return Val(x * y, w)
        if op == "/":
            return Val(x / y, w)
        if op == "%":
            # GLSL mod (execution.rs:423-430)
            return Val(x - y * torch.floor(x / y), w)
        ax, bx = x[..., 0], y[..., 0]
        if op == "==":
            m = ax == bx
        elif op == "!=":
            m = ax != bx
        elif op == "<":
            m = ax < bx
        elif op == "<=":
            m = ax <= bx
        elif op == ">":
            m = ax > bx
        elif op == ">=":
            m = ax >= bx
        elif op == "&&":
            m = (ax != 0.0) & (bx != 0.0)
        elif op == "||":
            m = (ax != 0.0) | (bx != 0.0)
        else:
            raise CompileError(f"unknown operator {op}")
        return Val(_stack3(m.float()), 1)

    # ---- calls ----

    def call(self, e: A.Call) -> Val:
        name = e.name
        fns = self.program.functions
        if name in fns:
            return self.call_user(fns[name], [self.eval(a) for a in e.args])
        builtin = getattr(self, f"_b_{name}", None)
        if builtin is not None:
            # string args (pattern names, format strings) stay AST-side;
            # builtins read them from e.args
            vals = [
                None if isinstance(a, A.Str) else self.eval(a) for a in e.args
            ]
            return builtin(vals, e)
        if self.host is not None:
            return self.host(name, e.args, self)
        raise CompileError(f"unknown function {name}")

    def call_user(self, fn: A.FnDef, args: List[Val]) -> Val:
        if self.depth >= MAX_RECURSION:
            raise CompileError(
                f"recursion in {fn.name} exceeds shader inline depth "
                f"{MAX_RECURSION} (use the host VM for recursive scripts)"
            )
        self.depth += 1
        saved_scopes = self.scopes
        saved_ret = getattr(self, "ret_val", None), getattr(self, "ret_mask", None)
        saved_active = self.active
        self.scopes = [self.scopes[0], {}]  # globals + fresh frame
        for p, v in zip(fn.params, args):
            self.scopes[-1][p] = v
        self.ret_val = None
        self.ret_mask = None
        saved_last = self.last_value
        self.last_value = None
        try:
            self.exec_block(fn.body, new_scope=False)
            if self.ret_val is not None:
                if self.ret_mask is True or self.ret_mask is None:
                    result = self.ret_val
                else:
                    base = self.last_value if self.last_value is not None else self._bc(0.0)
                    result = Val(
                        torch.where(self.ret_mask[..., None], self.ret_val.arr, base.arr),
                        self.ret_val.width,
                    )
            elif self.last_value is not None:
                result = self.last_value
            else:
                result = self._bc(0.0)
        finally:
            self.scopes = saved_scopes
            self.ret_val, self.ret_mask = saved_ret
            self.active = saved_active
            self.last_value = saved_last
            self.depth -= 1
        return result

    # ---- builtins (NodeOp intrinsics, execution.rs:330-770) ----

    def _cw(self, fn, args, width=None):
        a = args[0]
        return Val(fn(a.arr), width if width is not None else a.width)

    def _b_abs(self, a, e):
        return self._cw(torch.abs, a)

    def _b_sin(self, a, e):
        return self._cw(torch.sin, a)

    def _b_cos(self, a, e):
        return self._cw(torch.cos, a)

    def _b_tan(self, a, e):
        return self._cw(torch.tan, a)

    def _b_atan(self, a, e):
        if len(a) == 2:
            return Val(torch.atan2(a[0].arr, a[1].arr), max(a[0].width, a[1].width))
        return self._cw(torch.atan, a)

    def _b_atan2(self, a, e):
        return Val(torch.atan2(a[0].arr, a[1].arr), max(a[0].width, a[1].width))

    def _b_floor(self, a, e):
        return self._cw(torch.floor, a)

    def _b_ceil(self, a, e):
        return self._cw(torch.ceil, a)

    def _b_round(self, a, e):
        # Rust round: half away from zero
        return self._cw(lambda x: torch.sign(x) * torch.floor(torch.abs(x) + 0.5), a)

    def _b_fract(self, a, e):
        return self._cw(lambda x: x - torch.floor(x), a)

    def _b_sqrt(self, a, e):
        return self._cw(torch.sqrt, a)

    def _b_log(self, a, e):
        return self._cw(torch.log, a)

    def _b_degrees(self, a, e):
        return self._cw(torch.rad2deg, a)

    def _b_radians(self, a, e):
        return self._cw(torch.deg2rad, a)

    def _b_mod(self, a, e):
        x, y = a[0].arr, a[1].arr
        return Val(x - y * torch.floor(x / y), max(a[0].width, a[1].width))

    def _b_min(self, a, e):
        return Val(torch.minimum(a[0].arr, a[1].arr), max(a[0].width, a[1].width))

    def _b_max(self, a, e):
        return Val(torch.maximum(a[0].arr, a[1].arr), max(a[0].width, a[1].width))

    def _b_pow(self, a, e):
        return Val(torch.pow(a[0].arr, a[1].arr), max(a[0].width, a[1].width))

    def _b_mix(self, a, e):
        x, y, t = a
        return Val(x.arr + (y.arr - x.arr) * t.arr, max(x.width, y.width))

    def _b_clamp(self, a, e):
        # jnp.clip: max with the low bound, then min with the high one
        return Val(torch.minimum(torch.maximum(a[0].arr, a[1].arr), a[2].arr), a[0].width)

    def _b_step(self, a, e):
        edge, x = a
        return Val((x.arr >= edge.arr).float(), max(edge.width, x.width))

    def _b_smoothstep(self, a, e):
        # scalar semantics on .x (execution.rs:458-476)
        e0, e1, x = a[0].x, a[1].x, a[2].x
        denom = e1 - e0
        t = torch.where(denom != 0.0, (x - e0) / torch.where(denom != 0.0, denom, 1.0), 0.0)
        t = torch.clamp(t, 0.0, 1.0)
        s = t * t * (3.0 - 2.0 * t)
        return Val(_stack3(s), 1)

    def _b_length(self, a, e):
        v = a[0]
        comps = [v.arr[..., i] for i in range(max(v.width, 1))]
        s = sum(c * c for c in comps)
        return Val(_stack3(torch.sqrt(s)), 1)

    def _b_dot(self, a, e):
        x, y = a
        w = max(x.width, y.width)
        s = sum(x.arr[..., i] * y.arr[..., i] for i in range(w))
        return Val(_stack3(s), 1)

    # arity-suffixed variants (rusteria nodeop.rs Sin1/Sin2/Cos1/Cos2/
    # Length2/Length3/Dot2/Dot3): read exactly N lanes, scalar/vec2 result
    def _b_length2(self, a, e):
        v = a[0].arr
        return Val(_stack3(torch.sqrt(v[..., 0] ** 2 + v[..., 1] ** 2)), 1)

    def _b_length3(self, a, e):
        v = a[0].arr
        return Val(_stack3(torch.sqrt(v[..., 0] ** 2 + v[..., 1] ** 2 + v[..., 2] ** 2)), 1)

    def _b_dot2(self, a, e):
        x, y = a[0].arr, a[1].arr
        return Val(_stack3(x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1]), 1)

    def _b_dot3(self, a, e):
        x, y = a[0].arr, a[1].arr
        s = (
            x[..., 0] * y[..., 0]
            + x[..., 1] * y[..., 1]
            + x[..., 2] * y[..., 2]
        )
        return Val(_stack3(s), 1)

    def _b_sin1(self, a, e):
        r = torch.sin(a[0].arr[..., 0])
        z = torch.zeros_like(r)
        return Val(torch.stack([r, z, z], dim=-1), 1)

    def _b_sin2(self, a, e):
        v = a[0].arr
        z = torch.zeros_like(v[..., 0])
        return Val(torch.stack([torch.sin(v[..., 0]), torch.sin(v[..., 1]), z], dim=-1), 2)

    def _b_cos1(self, a, e):
        r = torch.cos(a[0].arr[..., 0])
        z = torch.zeros_like(r)
        return Val(torch.stack([r, z, z], dim=-1), 1)

    def _b_cos2(self, a, e):
        v = a[0].arr
        z = torch.zeros_like(v[..., 0])
        return Val(torch.stack([torch.cos(v[..., 0]), torch.cos(v[..., 1]), z], dim=-1), 2)

    def _b_cross(self, a, e):
        x, y = torch.broadcast_tensors(a[0].arr, a[1].arr)
        return Val(torch.stack([
            x[..., 1] * y[..., 2] - x[..., 2] * y[..., 1],
            x[..., 2] * y[..., 0] - x[..., 0] * y[..., 2],
            x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0],
        ], dim=-1), 3)

    def _b_normalize(self, a, e):
        v = a[0]
        comps = [v.arr[..., i] for i in range(max(v.width, 1))]
        s = torch.sqrt(sum(c * c for c in comps))
        s = torch.clamp(s, min=1e-30)
        out = v.arr / s[..., None]
        if v.width < 3:
            # zero out unused lanes to keep vec2 semantics
            out = out * _f32([1.0] * v.width + [0.0] * (3 - v.width), self.device)
        return Val(out, v.width)

    def _b_rotate2d(self, a, e):
        """Rotate2D (rotate .xy by angle.x)."""
        p, ang = a[0].arr, a[1].x
        ca, sa = torch.cos(ang), torch.sin(ang)
        x = p[..., 0] * ca - p[..., 1] * sa
        y = p[..., 0] * sa + p[..., 1] * ca
        return Val(torch.stack([x, y, torch.zeros_like(x)], dim=-1), 2)

    def _vec_ctor(self, args, n):
        comps = []
        for v in args:
            take = 1 if len(args) > 1 else v.width
            if len(args) == 1 and v.width == 1:
                # broadcast single scalar
                comps = [v.arr[..., 0]] * n
                break
            for i in range(min(take, 3)):
                comps.append(v.arr[..., i])
        while len(comps) < 3:
            comps.append(torch.zeros_like(comps[0]))
        comps = torch.broadcast_tensors(*comps[:3])
        return Val(torch.stack(comps, dim=-1), n)

    def _b_vec2(self, a, e):
        return self._vec_ctor(a, 2)

    def _b_vec3(self, a, e):
        return self._vec_ctor(a, 3)

    def _b_sample(self, a, e):
        if len(e.args) < 2 or not isinstance(e.args[1], A.Str):
            raise CompileError('sample(uv, "pattern") needs a pattern name')
        pat = e.args[1].value.lower()
        if pat not in PATTERN_NAMES:
            return self._bc(0.0)
        bank = self.program.pattern_bank_dev(self.device)
        uv = a[0]
        s = sample_pattern_jnp(bank, PATTERN_NAMES[pat], uv.arr[..., 0], uv.arr[..., 1])
        return Val(_stack3(s), 3)

    def _b_sample_normal(self, a, e):
        z = torch.zeros_like(a[0].arr[..., 0])
        return Val(torch.stack([z, z, z + 1.0], dim=-1), 3)

    def _b_palette(self, a, e):
        if self.palette is None:
            return self._bc(0.0)
        idx = torch.clamp(a[0].x.to(torch.int32), 0, len(self.palette) - 1)
        pal = torch.as_tensor(np.asarray(self.palette), device=self.device)
        return Val(pal[idx.long()], 3)

    def _b_print(self, a, e):
        return self._bc(0.0)

    # ---- host-mode texture builtins (execution.rs:656-741) ----
    #
    # These run at the top level of a texture script (make_textures.rusteria),
    # where indices and sizes are concrete Python ints. The reference's rayon
    # per-pixel iterate loop becomes one whole-grid evaluation on the
    # evaluator's device.

    def _concrete_scalar(self, v: Val) -> float:
        return float(v.arr.reshape(-1)[0])

    def _b_alloc(self, a, e):
        """alloc(w, h) -> texture index (execution.rs:656-663)."""
        w = int(self._concrete_scalar(a[0]))
        h = int(self._concrete_scalar(a[1]))
        idx = len(self.textures)
        self.textures.append(np.zeros((h, w, 3), np.float32))
        return self._bc(float(idx))

    def _b_iterate(self, a, e):
        """iterate(tex, "fn") — evaluate fn over every texel
        (execution.rs:664-715): per-pixel uv, registers carried from the
        current context; result is the fn's explicit return value, else the
        color register after the call."""
        if len(e.args) != 2 or not isinstance(e.args[1], A.Str):
            raise CompileError('iterate(tex, "fn_name") expects a string literal')
        fname = e.args[1].value
        fn = self.program.functions.get(fname)
        if fn is None:
            raise CompileError(f"iterate: unknown function {fname}")
        idx = int(self._concrete_scalar(a[0]))
        tex = self.textures[idx]
        h, w = tex.shape[:2]
        dev = self.device
        carried = {
            k: v.reshape(-1, 3)[0]
            for k, v in self.state.items()
            if k != "uv"
        }
        program = self.program
        has_return = program._scan(
            fn.body, lambda n: isinstance(n, A.Return) and n.value is not None
        )
        uu, vv = _uv_grid(w, h, dev)
        state = {"uv": torch.stack([uu, vv, torch.zeros_like(uu)], dim=-1)}
        for k, c in carried.items():
            state[k] = torch.broadcast_to(c, (h, w, 3))
        ev = Evaluator(program, state, self.palette, device=dev, traced=True)
        ev.scopes[0].update(self.scopes[0])
        res = ev.call_user(fn, [])
        out = res.arr if has_return else ev.state["color"]
        self.textures[idx] = torch.broadcast_to(out, (h, w, 3)).cpu().numpy().copy()
        return self._bc(float(idx))

    def _b_save(self, a, e):
        """save(tex, "path.png") — store texture + derived normal map
        (execution.rs:716-741). Script paths are relative to the reference
        repo layout; results land in self.saved by stem, and file IO only
        happens when save_dir is set (basenames, never the script's dirs)."""
        import os

        if len(e.args) != 2 or not isinstance(e.args[1], A.Str):
            raise CompileError('save(tex, "path.png") expects a string literal')
        idx = int(self._concrete_scalar(a[0]))
        tex = self.textures[idx]
        normal = texture_to_normal_map(tex, 5.0)
        path = e.args[1].value
        stem, ext = os.path.splitext(os.path.basename(path))
        ext = ext or ".png"
        self.saved[stem] = tex
        self.saved[stem + "_normal"] = normal
        if self.save_dir is not None:
            from PIL import Image

            os.makedirs(self.save_dir, exist_ok=True)
            for name, img in ((stem + ext, tex), (f"{stem}_normal{ext}", normal)):
                u8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
                Image.fromarray(u8, "RGB").save(os.path.join(self.save_dir, name))
        return self._bc(0.0)


def texture_to_normal_map(tex: np.ndarray, strength: float = 5.0) -> np.ndarray:
    """Height-field -> tangent-space normal map, packed to [0,1].

    Vectorized port of TexStorage::to_normal_map (rusteria/src/textures/
    mod.rs): Rec.709 luminance, wrap-around central differences, Z-up."""
    lum = tex[..., 0] * 0.2126 + tex[..., 1] * 0.7152 + tex[..., 2] * 0.0722
    dx = (np.roll(lum, -1, axis=1) - np.roll(lum, 1, axis=1)) * 0.5 * strength
    dy = (np.roll(lum, -1, axis=0) - np.roll(lum, 1, axis=0)) * 0.5 * strength
    n = np.stack([-dx, -dy, np.ones_like(dx)], axis=-1)
    length = np.sqrt((n * n).sum(-1, keepdims=True))
    n = np.where(length > 0, n / length, n)
    return ((n + 1.0) * 0.5).astype(np.float32)


def input_loads(module: A.Module) -> frozenset:
    """Registers whose INCOMING value a program may read.

    Pack-time baking (scene_pack) evaluates shade() over a uv grid with
    DEFAULT register inputs; at runtime the rasterizer supplies real
    per-pixel values for `color` (the texel), `normal` (interpolated),
    `hitpoint` (world position), and — under per-batch materials —
    `roughness`/`metallic`/`opacity`. A shader that reads any of those
    before fully overwriting them bakes silently wrong, so the bake gate
    consults this set (reference analogue: the VM reads registers live per
    pixel, rusteria/src/node/execution.rs:600-660, so it has no such gate).

    Conservative definite-assignment walk: a register counts as loaded
    unless a plain `=` to the bare name dominates the read on every path.
    Swizzle stores and augmented ops read-modify-write; If/Match join by
    intersection; loop bodies and helper functions are analyzed against
    their entry state (registers are global — Evaluator.lookup falls
    through scopes into `state`); `let`/params that shadow a register name
    are ignored (reads after them still flag)."""
    loads: set = set()
    fns = module.functions()

    def expr(e, assigned):
        if isinstance(e, A.Ident):
            if e.name in REGISTER_WIDTHS and e.name not in assigned:
                loads.add(e.name)
        elif isinstance(e, A.Swizzle):
            expr(e.base, assigned)
        elif isinstance(e, A.Unary):
            expr(e.operand, assigned)
        elif isinstance(e, A.Binary):
            expr(e.left, assigned)
            expr(e.right, assigned)
        elif isinstance(e, A.Ternary):
            expr(e.cond, assigned)
            expr(e.then, assigned)
            expr(e.other, assigned)
        elif isinstance(e, A.Call):
            for a in e.args:
                expr(a, assigned)

    def stmt_seq(stmts, assigned, stack):
        assigned = set(assigned)
        for s in stmts:
            if isinstance(s, A.Assign):
                expr(s.value, assigned)
                if isinstance(s.target, A.Ident):
                    name = s.target.name
                    if s.op != "=" and name in REGISTER_WIDTHS:
                        if name not in assigned:
                            loads.add(name)
                    if name in REGISTER_WIDTHS:
                        assigned.add(name)
                elif isinstance(s.target, A.Swizzle) and isinstance(
                    s.target.base, A.Ident
                ):
                    name = s.target.base.name
                    # partial store: unwritten components still leak through
                    if name in REGISTER_WIDTHS and name not in assigned:
                        loads.add(name)
                else:
                    expr(s.target, assigned)
            elif isinstance(s, A.Let):
                expr(s.value, assigned)
            elif isinstance(s, A.ExprStmt):
                expr(s.expr, assigned)
                assigned = call_effects(s.expr, assigned, stack)
            elif isinstance(s, A.If):
                expr(s.cond, assigned)
                a1 = stmt_seq(s.then, assigned, stack)
                a2 = stmt_seq(s.other or [], assigned, stack)
                assigned = a1 & a2
            elif isinstance(s, A.Match):
                expr(s.subject, assigned)
                arms = [stmt_seq(body, assigned, stack) for _p, body in s.arms]
                has_default = any(p is None for p, _b in s.arms)
                joined = set.intersection(*arms) if arms else set(assigned)
                assigned = joined if has_default else (joined & assigned)
            elif isinstance(s, A.For):
                assigned = stmt_seq(s.init, assigned, stack)
                expr(s.cond, assigned)
                stmt_seq(s.body + s.incr, assigned, stack)
            elif isinstance(s, A.While):
                expr(s.cond, assigned)
                stmt_seq(s.body, assigned, stack)
            elif isinstance(s, A.Return):
                if s.value is not None:
                    expr(s.value, assigned)
            elif isinstance(s, A.FnDef):
                pass  # bodies analyzed at call sites
        return assigned

    def call_effects(e, assigned, stack):
        """Helper-function bodies run against the caller's register state;
        their definite assignments persist (registers are global)."""
        if isinstance(e, A.Call) and e.name in fns and e.name not in stack:
            return stmt_seq(fns[e.name].body, assigned, stack | {e.name})
        return assigned

    # expression-position user calls also walk callee bodies for loads —
    # patch expr's Call case through a second pass over the module keeps the
    # code simpler: analyze every function body from the entry points.
    top = [s for s in module.stmts if not isinstance(s, A.FnDef)]
    assigned = stmt_seq(top, set(), frozenset())
    if "shade" in fns:
        stmt_seq(fns["shade"].body, assigned, frozenset({"shade"}))
    # calls nested inside expressions (let x = helper();) bypass
    # call_effects above; cover them by analyzing every OTHER function
    # body against the weakest (empty) assumption — conservative, and only
    # adds loads, never removes
    for name, fn in fns.items():
        if name != "shade":
            stmt_seq(fn.body, set(), frozenset({name}))
    return frozenset(loads)


class Program:
    """Compiled shader: AST + metadata; `shade` evaluates it over the
    caller's register state."""

    def __init__(self, module: A.Module):
        self.module = module
        self.functions = module.functions()
        self.shade_index = "shade" in self.functions
        #: registers whose incoming per-pixel value may be read (bake gate)
        self.input_loads = input_loads(module)
        self.supports_opacity = self._scan(
            module.stmts,
            lambda n: isinstance(n, A.Assign)
            and isinstance(n.target, A.Ident)
            and n.target.name == "opacity",
        )
        #: True when the shader reads `time` — such programs cannot be baked
        #: to a static atlas tile and stay on the per-pixel path
        self.uses_time = self._scan(
            module.stmts, lambda n: isinstance(n, A.Ident) and n.name == "time"
        )
        self._bank_dev = {}

    def _scan(self, stmts, pred) -> bool:
        found = False

        def walk(node):
            nonlocal found
            if pred(node):
                found = True
            for attr in getattr(node, "__dict__", {}).values():
                if isinstance(attr, list):
                    for x in attr:
                        if hasattr(x, "__dict__") or isinstance(x, tuple):
                            if isinstance(x, tuple):
                                for y in x:
                                    if hasattr(y, "__dict__"):
                                        walk(y)
                                    elif isinstance(y, list):
                                        for z in y:
                                            walk(z)
                            else:
                                walk(x)
                elif hasattr(attr, "__dict__"):
                    walk(attr)

        for s in stmts:
            walk(s)
        return found

    def pattern_bank_dev(self, device):
        """The pattern bank as a tensor on `device`, uploaded once."""
        key = str(torch.device(device))
        if key not in self._bank_dev:
            self._bank_dev[key] = torch.from_numpy(pattern_bank()).to(device)
        return self._bank_dev[key]

    def run_globals(self, ev: Evaluator):
        for s in self.module.stmts:
            if not isinstance(s, A.FnDef):
                ev.exec_stmt(s)

    def shade(self, state: Dict, palette=None) -> Dict:
        """Run top-level lets + fn shade() over the register state dict.

        state values are f32 tensors shaped (..., 3) on one device; mutated
        registers are returned in a new dict. Every `if` runs under lane
        masks (traced, as the JAX package always shades inside a jitted
        program)."""
        state = dict(state)
        ev = Evaluator(self, state, palette, traced=True)
        self.run_globals(ev)
        if self.shade_index:
            ev.call_user(self.functions["shade"], [])
        return ev.state

    def run(self, state: Optional[Dict] = None, palette=None, device=None):
        """Execute top-level statements; returns (state, last value tensor).

        Mirrors `VM::execute_string` semantics for numeric scripts. `device`
        as for resolve_device (None: CUDA)."""
        dev = resolve_device(device)
        state = dict(state or {})
        ev = Evaluator(self, state, palette, device=dev)
        self.run_globals(ev)
        last = ev.last_value.arr if ev.last_value is not None else torch.zeros(3, device=dev)
        return ev.state, last


def _uv_grid(width: int, height: int, device):
    """Pixel-centre uv over a width x height grid -> (uu, vv), (height,
    width) each: (i + 0.5) / n, divided by an f32 tensor (torch divides by
    a Python number as a multiply by its reciprocal on the card)."""
    def axis(n):
        i = torch.arange(n, dtype=torch.float32, device=device) + 0.5
        return i / torch.tensor(float(n), dtype=torch.float32, device=device)

    vv, uu = torch.meshgrid(axis(height), axis(width), indexing="ij")
    return uu, vv


def _default_state(uu, vv, time: float) -> Dict:
    """The registers' default inputs over a uv grid (the JAX package's bake
    state), each (H, W, 3)."""
    zeros = torch.zeros_like(uu)

    def r3(x):
        return _stack3(x)

    return {
        "uv": torch.stack([uu, vv, zeros], dim=-1),
        "color": r3(zeros),
        "roughness": r3(zeros + 0.5),
        "metallic": r3(zeros),
        "emissive": r3(zeros),
        "opacity": r3(zeros + 1.0),
        "bump": r3(zeros),
        "normal": r3(zeros),
        "hitpoint": r3(zeros),
        "time": r3(zeros + float(np.float32(time))),
    }


class Rusteria:
    """Facade mirroring the reference API (rusteria/src/lib.rs:57-210).

    Each entry point that evaluates takes `device` (resolve_device: None is
    CUDA and raises without it; "cpu" runs on the CPU) and returns numpy
    arrays."""

    @staticmethod
    def parse_str(src: str) -> A.Module:
        return parse(src)

    @staticmethod
    def parse_and_compile(src: str) -> Optional[Program]:
        try:
            return Program(parse(src))
        except (ParseError, CompileError):
            return None

    @staticmethod
    def execute_script(src_or_program, palette=None, save_dir=None, device=None) -> Evaluator:
        """Run a host-mode texture script — the reference's
        make_textures.rusteria flow of alloc/iterate/save top-level calls
        (rusteria/src/node/execution.rs:656-741). Returns the Evaluator with
        `.textures` (list of (H,W,3) f32) and `.saved` ({stem: image, incl.
        derived *_normal maps}) populated. Each iterate is one whole-grid
        evaluation on `device`."""
        program = (
            src_or_program
            if isinstance(src_or_program, Program)
            else Program(parse(src_or_program))
        )
        dev = resolve_device(device)
        zeros = torch.zeros(3, dtype=torch.float32, device=dev)
        state = {
            "uv": zeros,
            "color": zeros,
            "roughness": zeros + 0.5,
            "metallic": zeros,
            "emissive": zeros,
            "opacity": zeros + 1.0,
            "bump": zeros,
            "normal": zeros,
            "hitpoint": zeros,
            "time": zeros,
        }
        ev = Evaluator(program, state, palette, device=dev)
        ev.save_dir = save_dir
        program.run_globals(ev)
        return ev

    @staticmethod
    def shade_image(program: Program, width: int, height: int, palette=None,
                    time: float = 0.0, device=None):
        """Offline bake: evaluate fn shade() over a WxH uv grid -> (H,W,3) f32.

        Replaces the reference's rayon 80x80-tile bake (lib.rs:161-210) with
        one whole-image evaluation on `device`."""
        uu, vv = _uv_grid(width, height, resolve_device(device))
        out = program.shade(_default_state(uu, vv, time), palette)
        return torch.broadcast_to(out["color"], (height, width, 3)).cpu().numpy().copy()

    @staticmethod
    def bake_tile(program: Program, size: int = 128, palette=None,
                  time: float = 0.0, device=None) -> np.ndarray:
        """Bake fn shade() to a (size, size, 4) RGBA8 texture over shader-uv
        [0,1)^2 — the reference's chunk-shader pre-bake (src/chunk.rs:104-121)
        generalized to per-batch shaders so shaded batches stay on the
        uniform texture path. Alpha comes from the shader's opacity register
        when the program writes it."""
        uu, vv = _uv_grid(size, size, resolve_device(device))
        out = program.shade(_default_state(uu, vv, time), palette)
        rgb = torch.broadcast_to(out["color"], (size, size, 3))
        a = torch.broadcast_to(out["opacity"], (size, size, 3))[..., :1]
        rgba = torch.cat([rgb, a], dim=-1).cpu().numpy().copy()
        if not program.supports_opacity:
            rgba[..., 3] = 1.0
        # encode linear shader color for the sRGB-decoding texel samplers
        # (reference gamma-encodes its bakes too, renderbuffer.rs:88-107)
        from ..utils.color import linear_to_srgb_exact_inverse

        rgba[..., :3] = linear_to_srgb_exact_inverse(rgba[..., :3])
        return (np.clip(rgba, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)

    @staticmethod
    def bake_state(program: Program, size: int = 128, palette=None,
                   time: float = 0.0, device=None) -> dict:
        """Evaluate fn shade() over the bake grid and return ALL shader
        output registers (numpy f32): color/opacity plus roughness,
        metallic, emissive, normal, bump. Used by pack-time bake
        eligibility — a shader that writes non-default material registers
        only bakes when those are representable (emissive 0, normal/bump
        untouched, roughness/metallic spatially constant; scene_pack)."""
        uu, vv = _uv_grid(size, size, resolve_device(device))
        out = program.shade(_default_state(uu, vv, time), palette)
        full = (size, size, 3)
        return {
            k: torch.broadcast_to(out[k], full).cpu().numpy().copy()
            for k in (
                "color", "opacity", "roughness", "metallic",
                "emissive", "normal", "bump",
            )
        }
