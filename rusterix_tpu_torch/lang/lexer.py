"""Lexer for the rusteria shading / entity-script language.

Language surface per the reference's scanner (reference
rusteria/src/scanner.rs) as exercised by main.rusteria,
examples/cube_shaded.rs:46-102, and the entity-VM language tests
(src/vm/mod.rs:163-330): C-like tokens, // and /* */ comments, numbers,
strings, identifiers, swizzle via '.', compound assignment ops.
"""

from __future__ import annotations

from dataclasses import dataclass

KEYWORDS = {
    "let", "fn", "if", "else", "for", "while", "return", "match", "break",
    "continue", "true", "false",
}

TWO_CHAR = {
    "==", "!=", "<=", ">=", "&&", "||", "+=", "-=", "*=", "/=", "%=",
}

SINGLE = set("+-*/%(){}[],;:?.<>=!&|_")


@dataclass
class Token:
    kind: str  # 'num', 'str', 'ident', 'kw', 'op', 'eof'
    value: str
    line: int


class LexError(Exception):
    pass


def tokenize(src: str):
    tokens = []
    i = 0
    line = 1
    n = len(src)
    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if src.startswith("//", i):
            while i < n and src[i] != "\n":
                i += 1
            continue
        if src.startswith("/*", i):
            end = src.find("*/", i + 2)
            if end < 0:
                raise LexError(f"unterminated block comment at line {line}")
            line += src.count("\n", i, end)
            i = end + 2
            continue
        if c == '"':
            j = i + 1
            buf = []
            while j < n and src[j] != '"':
                if src[j] == "\\" and j + 1 < n:
                    esc = src[j + 1]
                    buf.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(esc, esc))
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise LexError(f"unterminated string at line {line}")
            tokens.append(Token("str", "".join(buf), line))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            # Numbers, incl. leading-dot (`.1031`) and trailing-dot (`1.`,
            # `w/2.`) floats. The reference scanner always consumes a dot
            # following the integer part, appending an implicit 0 when no
            # fraction digits follow (rusteria/src/scanner.rs:392-402) —
            # make_textures.rusteria:211 relies on this.
            j = i
            if src[j] == ".":
                j += 1
                while j < n and src[j].isdigit():
                    j += 1
            else:
                while j < n and src[j].isdigit():
                    j += 1
                if j < n and src[j] == ".":
                    j += 1
                    while j < n and src[j].isdigit():
                        j += 1
            tokens.append(Token("num", src[i:j], line))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            if word == "_" :
                tokens.append(Token("op", "_", line))
            elif word in KEYWORDS:
                tokens.append(Token("kw", word, line))
            else:
                tokens.append(Token("ident", word, line))
            i = j
            continue
        if i + 1 < n and src[i : i + 2] in TWO_CHAR:
            tokens.append(Token("op", src[i : i + 2], line))
            i += 2
            continue
        if c in SINGLE:
            tokens.append(Token("op", c, line))
            i += 1
            continue
        raise LexError(f"unexpected character {c!r} at line {line}")
    tokens.append(Token("eof", "", line))
    return tokens
