"""Message token parser (reference src/client/parser.rs).

Grammar: `{...}` tokens inside messages —
  {the,case=upper}            text key + options
  {E:20.name,article=def}     entity attribute
  {It:102.name,article=indef} item attribute
  {N:50,unit=hp}              integer
  {F:3.14,precision=2}        float
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Tok:
    kind: str  # 'text', 'entity', 'item', 'num', 'float', 'plain'
    text: str = ""
    id: int = 0
    attr: str = ""
    val: float = 0.0
    opts: Dict[str, str] = field(default_factory=dict)


_BRACE_RE = re.compile(r"\{([^{}]+)\}")

#: EnLocale article tables (resolver.rs:20-60)
_AN_EXCEPTIONS = ("honest", "honor", "honour", "hour", "heir")
_A_EXCEPTIONS = ("uni", "use", "euro", "one")  # unicorn, user, euro, one-off
_PAIR_ITEMS = ("trousers", "pants", "gloves", "boots", "scissors", "goggles")
_MASS_ITEMS = (
    "armor", "cloth", "water", "meat", "sand", "rice", "bread", "equipment",
)


def _indefinite_article(word: str) -> str:
    """EnLocale::indefinite_article (resolver.rs:21-41)."""
    if not word:
        return "a"
    if word.startswith(_AN_EXCEPTIONS):
        return "an"
    if word.startswith(_A_EXCEPTIONS):
        return "a"
    return "an" if word[:1].lower() in "aeiou" else "a"


def _with_article(name: str, opts: Dict[str, str]) -> str:
    """EnLocale::with_article_item/_entity (resolver.rs:62-90): definite ->
    'the X'; indefinite -> 'a pair of X' for pair items, 'some X' for mass
    nouns, else 'a/an X' with the exception tables above."""
    article = opts.get("article")
    if article is None:
        return name
    article = article.lower()
    if article in ("def", "definite"):
        return f"the {name}"
    if article in ("indef", "indefinite", "undef"):
        lower = name.lower()
        if any(p in lower for p in _PAIR_ITEMS):
            return f"a pair of {name}"
        if any(m in lower for m in _MASS_ITEMS):
            return f"some {name}"
        return f"{_indefinite_article(lower)} {name}"
    return name


def _ucfirst(s: str) -> str:
    return s[:1].upper() + s[1:] if s else s


def _title(s: str) -> str:
    return " ".join(_ucfirst(w) for w in s.split())


def _apply_case(text: str, opts: Dict[str, str]) -> str:
    """MsgResolver::apply_case (resolver.rs:207-272): `case=` spellings
    upper/uppercase, lower/lowercase, ucfirst/first/first_upper, title —
    plus the same names as bare boolean-style option keys."""
    case = (opts.get("case") or "").lower()
    if case in ("upper", "uppercase"):
        return text.upper()
    if case in ("lower", "lowercase"):
        return text.lower()
    if case in ("ucfirst", "first", "first_upper"):
        return _ucfirst(text)
    if case == "title":
        return _title(text)
    if "upper" in opts:
        return text.upper()
    if "lower" in opts:
        return text.lower()
    if "ucfirst" in opts or "first" in opts or "first_upper" in opts:
        return _ucfirst(text)
    if "title" in opts:
        return _title(text)
    return text


class MsgParser:
    def parse(self, input_str: str) -> List[Tok]:
        toks: List[Tok] = []
        last = 0
        for m in _BRACE_RE.finditer(input_str):
            if m.start() > last:
                toks.append(Tok("plain", text=input_str[last : m.start()]))
            toks.append(self._parse_token(m.group(1)))
            last = m.end()
        if last < len(input_str):
            toks.append(Tok("plain", text=input_str[last:]))
        return toks

    def _parse_token(self, body: str) -> Tok:
        parts = body.strip().split(",")
        head = parts[0].strip()
        # k=v pairs; values may be 'quoted' or "quoted" (parser.rs:164-180);
        # flag-only segments are dropped, as in the reference
        opts = {}
        for p in parts[1:]:
            if "=" in p:
                k, v = p.split("=", 1)
                v = v.strip()
                if len(v) >= 2 and v[0] == v[-1] and v[0] in "\"'":
                    v = v[1:-1]
                opts[k.strip()] = v
        lower = head.lower()

        def ref(kind, rest):
            # malformed id -> TextKey with the FULL body including option
            # segments (parser.rs:131-136)
            id_attr = rest.split(".", 1)
            try:
                rid = int(id_attr[0])
                if rid < 0:
                    raise ValueError(rid)
            except ValueError:
                return Tok("text", text=body.strip(), opts={})
            return Tok(
                kind,
                id=rid,
                attr=id_attr[1] if len(id_attr) > 1 else "name",
                opts=opts,
            )

        if lower.startswith("e:"):
            return ref("entity", head[2:])
        # item refs: I: / It: / Item:, case-insensitive (parser.rs:76-84) —
        # region.rs:1323 emits the short {I:<id>.name} form on purchases
        for prefix in ("item:", "it:", "i:"):
            if lower.startswith(prefix):
                return ref("item", head[len(prefix):])
        # non-numeric N:/F: payloads degrade to text keys (parser.rs:85-102)
        if lower.startswith("n:"):
            try:
                return Tok("num", val=float(int(head[2:])), opts=opts)
            except ValueError:
                return Tok("text", text=head, opts=opts)
        if lower.startswith("f:"):
            try:
                return Tok("float", val=float(head[2:]), opts=opts)
            except ValueError:
                return Tok("text", text=head, opts=opts)
        return Tok("text", text=head, opts=opts)

    def render(
        self,
        input_str: str,
        entities=None,
        items=None,
        locale: Optional[Dict[str, str]] = None,
    ) -> str:
        """Expand tokens to display text."""
        pieces = []
        for tok in self.parse(input_str):
            if tok.kind == "plain":
                pieces.append(tok.text)
            elif tok.kind == "text":
                pieces.append(
                    _apply_case((locale or {}).get(tok.text, tok.text), tok.opts)
                )
            elif tok.kind == "entity":
                # unresolved refs degrade to the reference's placeholder
                # (resolver.rs:144) before the article is applied
                name = f"Entity#{tok.id}:{tok.attr}"
                for e in entities or []:
                    if e.id == tok.id:
                        name = e.attributes.get_str_default(tok.attr, "")
                        break
                pieces.append(
                    _apply_case(_with_article(name, tok.opts), tok.opts)
                )
            elif tok.kind == "item":
                # world items first, then entity inventories
                # (resolver.rs:156-186); unresolved -> the reference's
                # placeholder degrade path (resolver.rs:158)
                name = ""
                for i in items or []:
                    if i.id == tok.id:
                        name = i.attributes.get_str_default(tok.attr, "")
                        break
                if not name:
                    for e in entities or []:
                        for _, inv_item in e.iter_inventory():
                            if inv_item.id == tok.id:
                                name = inv_item.attributes.get_str_default(
                                    tok.attr, ""
                                )
                                break
                        if name:
                            break
                if not name:
                    name = f"Item#{tok.id}:{tok.attr}"
                pieces.append(
                    _apply_case(_with_article(name, tok.opts), tok.opts)
                )
            elif tok.kind == "num":
                text = f"{int(tok.val)}"
                if "unit" in tok.opts:
                    text += f" {tok.opts['unit']}"
                pieces.append(text)
            elif tok.kind == "float":
                try:
                    prec = int(tok.opts.get("precision", 2))
                except ValueError:
                    prec = 2
                text = f"{tok.val:.{prec}f}"
                if "unit" in tok.opts:
                    text += f" {tok.opts['unit']}"
                pieces.append(text)

        # auto-space between consecutive WORDY tokens (resolver.rs:192-200:
        # templates like "{You}{E:7.name,article=def}" need no literal
        # spaces). Documented-intent divergence: the reference inserts the
        # space even when the boundary already has one (a plain chunk ending
        # " " is wordy, so "You see {E:..}" would double-space); we skip the
        # insertion when either side already touches whitespace.
        out = ""
        prev_wordy = False
        for rendered in pieces:
            curr_wordy = any(c.isalnum() for c in rendered)
            if (
                prev_wordy
                and curr_wordy
                and out
                and not out[-1].isspace()
                and not (rendered[:1].isspace())
            ):
                out += " "
            out += rendered
            prev_wordy = curr_wordy
        return out
