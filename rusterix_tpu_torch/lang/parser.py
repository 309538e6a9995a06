"""Recursive-descent parser for the rusteria language.

Grammar per the reference parser (rusteria/src/parser.rs, 1,288 LoC) as
exercised by main.rusteria, the wood shader (examples/cube_shaded.rs:46-102)
and the entity-VM tests (src/vm/mod.rs:163-330):

  module    := (fn_def | stmt)*
  fn_def    := 'fn' IDENT '(' params ')' block
  stmt      := 'let' IDENT '=' expr ';'
             | 'if' expr block ('else' (if_stmt | block))?
             | 'for' '(' init ';' expr ';' incr ')' block
             | 'while' expr block
             | 'return' expr? ';'
             | 'match' expr '{' (pattern block)* '}'
             | 'break' ';'
             | assign_or_expr ';'
  assign    := target ('='|'+='|'-='|'*='|'/='|'%=') expr
  expr      := ternary; ternary := or ('?' expr ':' expr)?
  or/and/eq/cmp/add/mul/unary/postfix/primary — C precedence
  postfix   := primary ( '(' args ')' | '.' swizzle )*
"""

from __future__ import annotations

from . import ast as A
from .lexer import Token, tokenize

SWIZZLE_MAP = {"x": 0, "y": 1, "z": 2, "r": 0, "g": 1, "b": 2}


class ParseError(Exception):
    pass


class Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.pos = 0

    # -- helpers --

    def peek(self) -> Token:
        return self.toks[self.pos]

    def next(self) -> Token:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def check(self, kind, value=None) -> bool:
        t = self.peek()
        return t.kind == kind and (value is None or t.value == value)

    def accept(self, kind, value=None):
        if self.check(kind, value):
            return self.next()
        return None

    def expect(self, kind, value=None) -> Token:
        t = self.peek()
        if t.kind != kind or (value is not None and t.value != value):
            raise ParseError(
                f"line {t.line}: expected {value or kind}, got {t.kind} {t.value!r}"
            )
        return self.next()

    # -- module --

    def parse_module(self) -> A.Module:
        stmts = []
        while not self.check("eof"):
            if self.check("kw", "fn"):
                stmts.append(self.fn_def())
            else:
                stmts.append(self.statement())
        return A.Module(stmts)

    def fn_def(self) -> A.FnDef:
        self.expect("kw", "fn")
        name = self.expect("ident").value
        self.expect("op", "(")
        params = []
        while not self.check("op", ")"):
            params.append(self.expect("ident").value)
            if not self.accept("op", ","):
                break
        self.expect("op", ")")
        body = self.block()
        return A.FnDef(name, params, body)

    def block(self):
        self.expect("op", "{")
        stmts = []
        while not self.check("op", "}"):
            stmts.append(self.statement())
        self.expect("op", "}")
        return stmts

    # -- statements --

    def statement(self):
        if self.check("kw", "let"):
            return self.let_stmt()
        if self.check("kw", "if"):
            return self.if_stmt()
        if self.check("kw", "for"):
            return self.for_stmt()
        if self.check("kw", "while"):
            return self.while_stmt()
        if self.check("kw", "return"):
            self.next()
            if self.accept("op", ";"):
                return A.Return(None)
            value = self.expression()
            self.accept("op", ";")
            return A.Return(value)
        if self.check("kw", "match"):
            return self.match_stmt()
        if self.check("kw", "break"):
            self.next()
            self.accept("op", ";")
            return A.Break()
        return self.assign_or_expr_stmt()

    def let_stmt(self):
        self.expect("kw", "let")
        name = self.expect("ident").value
        self.expect("op", "=")
        value = self.expression()
        self.accept("op", ";")
        return A.Let(name, value)

    def if_stmt(self):
        self.expect("kw", "if")
        # condition may be parenthesized or bare
        cond = self.expression()
        then = self.block()
        other = None
        if self.accept("kw", "else"):
            if self.check("kw", "if"):
                other = [self.if_stmt()]
            else:
                other = self.block()
        return A.If(cond, then, other)

    def for_stmt(self):
        self.expect("kw", "for")
        self.expect("op", "(")
        init = []
        if not self.check("op", ";"):
            if self.check("kw", "let"):
                init.append(self.let_stmt())
            else:
                init.append(self.assign_or_expr_stmt(consume_semi=False))
        if not init or not isinstance(init[0], A.Let):
            self.accept("op", ";")
        # A.Let consumes its own ';'
        cond = self.expression()
        self.expect("op", ";")
        incr = []
        if not self.check("op", ")"):
            incr.append(self.assign_or_expr_stmt(consume_semi=False))
        self.expect("op", ")")
        body = self.block()
        return A.For(init, cond, incr, body)

    def while_stmt(self):
        self.expect("kw", "while")
        cond = self.expression()
        body = self.block()
        return A.While(cond, body)

    def match_stmt(self):
        self.expect("kw", "match")
        subject = self.expression()
        self.expect("op", "{")
        arms = []
        while not self.check("op", "}"):
            if self.accept("op", "_"):
                pattern = None
            else:
                pattern = self.expression()
            body = self.block()
            arms.append((pattern, body))
        self.expect("op", "}")
        return A.Match(subject, arms)

    def assign_or_expr_stmt(self, consume_semi: bool = True):
        expr = self.expression()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "+=", "-=", "*=", "/=", "%="):
            if not isinstance(expr, (A.Ident, A.Swizzle)):
                raise ParseError(f"line {t.line}: invalid assignment target")
            op = self.next().value
            value = self.expression()
            if consume_semi:
                self.accept("op", ";")
            return A.Assign(expr, op, value)
        if consume_semi:
            self.accept("op", ";")
        return A.ExprStmt(expr)

    # -- expressions --

    def expression(self):
        return self.ternary()

    def ternary(self):
        cond = self.logical_or()
        if self.accept("op", "?"):
            then = self.expression()
            self.expect("op", ":")
            other = self.expression()
            return A.Ternary(cond, then, other)
        return cond

    def _binary_level(self, sub, ops):
        left = sub()
        while self.peek().kind == "op" and self.peek().value in ops:
            op = self.next().value
            right = sub()
            left = A.Binary(op, left, right)
        return left

    def logical_or(self):
        return self._binary_level(self.logical_and, ("||",))

    def logical_and(self):
        return self._binary_level(self.equality, ("&&",))

    def equality(self):
        return self._binary_level(self.comparison, ("==", "!="))

    def comparison(self):
        return self._binary_level(self.additive, ("<", "<=", ">", ">="))

    def additive(self):
        return self._binary_level(self.multiplicative, ("+", "-"))

    def multiplicative(self):
        return self._binary_level(self.unary, ("*", "/", "%"))

    def unary(self):
        t = self.peek()
        if t.kind == "op" and t.value in ("-", "!"):
            self.next()
            return A.Unary(t.value, self.unary())
        return self.postfix()

    def postfix(self):
        expr = self.primary()
        while True:
            if self.check("op", "("):
                if not isinstance(expr, A.Ident):
                    raise ParseError(
                        f"line {self.peek().line}: only named calls supported"
                    )
                self.next()
                args = []
                while not self.check("op", ")"):
                    args.append(self.expression())
                    if not self.accept("op", ","):
                        break
                self.expect("op", ")")
                expr = A.Call(expr.name, args)
            elif self.check("op", "."):
                self.next()
                comp = self.expect("ident").value
                try:
                    components = tuple(SWIZZLE_MAP[c] for c in comp)
                except KeyError:
                    raise ParseError(
                        f"line {self.peek().line}: bad swizzle .{comp}"
                    ) from None
                expr = A.Swizzle(expr, components)
            else:
                return expr

    def primary(self):
        t = self.next()
        if t.kind == "num":
            return A.Num(float(t.value))
        if t.kind == "str":
            return A.Str(t.value)
        if t.kind == "kw" and t.value == "true":
            return A.Num(1.0)
        if t.kind == "kw" and t.value == "false":
            return A.Num(0.0)
        if t.kind == "ident":
            return A.Ident(t.value)
        if t.kind == "op" and t.value == "(":
            e = self.expression()
            self.expect("op", ")")
            return e
        raise ParseError(f"line {t.line}: unexpected token {t.value!r}")


def parse(src: str) -> A.Module:
    return Parser(tokenize(src)).parse_module()
