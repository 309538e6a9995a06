"""AST for the rusteria language (reference rusteria/src/ast.rs shapes)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


# ---- expressions ----

@dataclass
class Num:
    value: float


@dataclass
class Str:
    value: str


@dataclass
class Ident:
    name: str


@dataclass
class Swizzle:
    base: object
    components: Tuple[int, ...]  # 0=x 1=y 2=z


@dataclass
class Unary:
    op: str  # '-', '!'
    operand: object


@dataclass
class Binary:
    op: str  # + - * / % == != < <= > >= && ||
    left: object
    right: object


@dataclass
class Ternary:
    cond: object
    then: object
    other: object


@dataclass
class Call:
    name: str
    args: List[object]


# ---- statements ----

@dataclass
class Let:
    name: str
    value: object


@dataclass
class Assign:
    # target: Ident or Swizzle over Ident
    target: object
    op: str  # '=', '+=', '-=', '*=', '/=', '%='
    value: object


@dataclass
class ExprStmt:
    expr: object


@dataclass
class If:
    cond: object
    then: List[object]
    other: Optional[List[object]] = None


@dataclass
class For:
    init: List[object]
    cond: object
    incr: List[object]
    body: List[object]


@dataclass
class While:
    cond: object
    body: List[object]


@dataclass
class Return:
    value: Optional[object]


@dataclass
class Break:
    pass


@dataclass
class Match:
    subject: object
    arms: List[Tuple[Optional[object], List[object]]]  # (pattern expr | None for _, body)


@dataclass
class FnDef:
    name: str
    params: List[str]
    body: List[object]


@dataclass
class Module:
    stmts: List[object] = field(default_factory=list)

    def functions(self):
        return {s.name: s for s in self.stmts if isinstance(s, FnDef)}
