"""Grid, Routine and Module: visual code -> rusteria source
(reference codegridfx/lib/src/{grid,routine,module}.rs).

The editor-canvas half of the reference (theframework widgets, hit testing,
drawing) is host-UI specific; this module carries the data model and the
code generation, which is what the engine consumes: entity/item modules
compile to `fn event(event, value)` scripts for the entity VM, shader
modules compile to `fn shade()` rusteria shaders.
"""

from __future__ import annotations

import enum
import json
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .cells import Cell, CellItem, CellItemForm, CellRole

USER_EVENTS = ("key_down", "key_up")  # module.rs:8


class ModuleType(enum.IntEnum):
    """module.rs:80-88."""

    Unknown = 0
    CharacterInstance = 1
    ItemInstance = 2
    CharacterTemplate = 3
    ItemTemplate = 4
    Shader = 5

    def is_instance(self) -> bool:
        return self in (ModuleType.CharacterInstance, ModuleType.ItemInstance)

    def is_shader(self) -> bool:
        return self == ModuleType.Shader


@dataclass
class Grid:
    """Sparse (col, row) -> CellItem grid + per-row block indents
    (grid.rs:10-100)."""

    grid: Dict[Tuple[int, int], CellItem] = field(default_factory=dict)
    row_indents: Dict[int, int] = field(default_factory=dict)

    def insert(self, coord: Tuple[int, int], item: CellItem) -> None:
        self.grid[tuple(coord)] = item

    def set_row_indent(self, row: int, indent: int) -> None:
        self.row_indents[row] = indent

    def grid_by_rows(self) -> List[List[Tuple[CellItem, Tuple[int, int]]]]:
        """grid.rs:399-417: rows sorted, cells sorted by column."""
        rows: Dict[int, List[Tuple[int, CellItem]]] = {}
        for (col, row), item in self.grid.items():
            rows.setdefault(row, []).append((col, item))
        out = []
        for row in sorted(rows):
            cols = sorted(rows[row], key=lambda p: p[0])
            out.append([(item, (col, row)) for col, item in cols])
        return out


def _emit_row(row, grid: Grid, row_code_parts: List[str]) -> Tuple[bool, bool]:
    """Shared inner-row emission (routine.rs:625-653): function-call closing
    parens, argument comma/paren joining, if/else detection."""
    is_if = is_else = False
    for index, (item, pos) in enumerate(row):
        if index == 0:
            if item.cell.kind == "If":
                is_if = True
            if item.cell.kind == "Else":
                is_else = True
        row_code_parts.append(item.code())
        if item.cell.role() == CellRole.Function and item.form == CellItemForm.Rounded:
            row_code_parts.append(")")
        if item.description:
            nxt = grid.grid.get((pos[0] + 1, pos[1]))
            if nxt is not None and nxt.description:
                row_code_parts.append(", ")
            else:
                row_code_parts.append(") ")
        if index == len(row) - 1:
            row_code_parts.append("{" if (is_if or is_else) else " ")
        else:
            row_code_parts.append(" ")
    return is_if, is_else


@dataclass
class Routine:
    """One event handler's grid (routine.rs:16-68)."""

    name: str = ""
    id: str = field(default_factory=lambda: str(uuid_mod.uuid4()))
    grid: Grid = field(default_factory=Grid)
    visible: bool = False
    folded: bool = False
    module_offset: int = 0
    # shader-only knobs
    pixelization: int = 0
    scale: float = 1.0
    rotation: float = 0.0
    color_steps: int = 0

    def build_source(self, out: List[str], indent: int, debug: bool = False) -> None:
        """Event-handler codegen (routine.rs:524-580)."""
        if self.name != "instantiation":
            if self.name.startswith("intent: "):
                cmd = self.name[len("intent: "):]
                out.append(
                    f'{"":{indent}}if event == "intent" && value == "{cmd}" {{\n'
                )
            else:
                out.append(f'{"":{indent}}if event == "{self.name}" {{\n')
            indent += 4

        if self.name == "take_damage":
            out.append(f'{"":{indent}}let from_id = value.subject_id;\n')
            out.append(f'{"":{indent}}let amount = value.amount;\n')
        elif self.name == "intent":
            out.append(f'{"":{indent}}let intent = value.string;\n')
            out.append(f'{"":{indent}}let distance = value.distance;\n')
        elif self.name in USER_EVENTS:
            out.append(f'{"":{indent}}let key = value;\n')

        prev_row_indent = indent
        for row in self.grid.grid_by_rows():
            parts: List[str] = []
            ind = indent
            first_item, first_pos = row[0]
            if debug:
                for item, pos in row:
                    if item.cell.role() == CellRole.Function:
                        parts.append(
                            f'set_debug_loc("{self.name}", {pos[0]}, {pos[1]}); '
                        )
            # `let` for a leading variable definition row
            if len(row) > 1 and first_item.cell.kind == "Variable":
                parts.append("let ")
            # indent management: close blocks when the indent decreases
            row_ind = self.grid.row_indents.get(first_pos[1])
            if row_ind is not None:
                target = indent + row_ind * 4
                while prev_row_indent > target:
                    prev_row_indent -= 4
                    out.append(f'{"":{prev_row_indent}}}}\n')
                ind = target
            else:
                while prev_row_indent > ind:
                    prev_row_indent -= 4
                    out.append(f'{"":{prev_row_indent}}}}\n')

            _emit_row(row, self.grid, parts)
            cleaned = "".join(parts).strip()
            if cleaned:
                if not cleaned.endswith("{"):
                    cleaned += ";"
                out.append(f'{"":{ind}}{cleaned}\n')
                prev_row_indent = ind

        while prev_row_indent > indent:
            prev_row_indent -= 4
            out.append(f'{"":{prev_row_indent}}}}\n')

        if self.name != "instantiation":
            indent -= 4
            out.append(f'{"":{indent}}}}\n')

    def build_shader(self, out: List[str], indent: int = 0) -> None:
        """Shader codegen (routine.rs:414-523)."""
        out.append("fn shade() {\n")
        indent += 4
        if self.scale != 1.0:
            out.append(f"    uv /= {self.scale};\n")
        if self.rotation != 0.0:
            out.append(f"    uv = rotate2d(uv, {self.rotation});\n")
        if self.pixelization > 0:
            out.append(
                f"    uv = floor(uv * {self.pixelization}) / {self.pixelization};\n"
            )

        reserved = {"color", "roughness", "metallic", "uv", "normal", "bump", "opacity"}
        declared: set = set()
        for row in self.grid.grid_by_rows():
            parts: List[str] = []
            ind = indent
            first_item, first_pos = row[0]
            code0 = first_item.code()
            if (
                first_item.cell.kind == "Variable"
                and code0 not in reserved
                and code0 not in declared
            ):
                parts.append("let ")
                declared.add(code0)
            ind += self.grid.row_indents.get(first_pos[1], 0) * 4
            _emit_row(row, self.grid, parts)
            out.append(f'{"":{ind}}{"".join(parts)};\n')

        if self.color_steps > 0:
            out.append(
                f"    color = floor(color * {self.color_steps}) / {self.color_steps};\n"
            )
        out.append("}\n")


@dataclass
class Module:
    """Named routines -> script source (module.rs:120-1180)."""

    name: str = ""
    module_type: ModuleType = ModuleType.CharacterInstance
    routines: Dict[str, Routine] = field(default_factory=dict)
    id: str = field(default_factory=lambda: str(uuid_mod.uuid4()))

    @staticmethod
    def as_type(t: ModuleType) -> "Module":
        return Module(module_type=t)

    def add_routine(self, name: str) -> Routine:
        r = Routine(name=name)
        self.routines[name] = r
        return r

    def contains(self, event: str) -> bool:
        return event in self.routines

    def build(self, debug: bool = False) -> str:
        """module.rs:1114-1153: templates wrap routines in
        fn event / fn user_event; instances emit fn setup."""
        out: List[str] = []
        if self.module_type in (ModuleType.CharacterTemplate, ModuleType.ItemTemplate):
            out.append("fn event(event, value) {\n")
            has_user = False
            for r in self.routines.values():
                if r.name in USER_EVENTS:
                    has_user = True
                else:
                    r.build_source(out, 4, debug)
            out.append("}\n\n")
            if has_user:
                out.append("fn user_event(event, value) {\n")
                for r in self.routines.values():
                    if r.name in USER_EVENTS:
                        r.build_source(out, 4, debug)
                out.append("}\n")
        else:
            out.append("fn setup() {\n")
            for r in self.routines.values():
                r.build_source(out, 4, debug)
            out.append("}\n")
        return "".join(out)

    def build_shader(self) -> str:
        """module.rs:1078-1095."""
        if not self.module_type.is_shader():
            return ""
        r = self.routines.get("shader")
        if r is None:
            return ""
        out: List[str] = []
        r.build_shader(out, 0)
        return "".join(out)

    def build_custom_shader(self, name: str) -> str:
        if not self.module_type.is_shader():
            return ""
        r = self.routines.get(name)
        if r is None:
            return ""
        out: List[str] = []
        r.build_shader(out, 0)
        return "".join(out)

    # ---- JSON round trip (module.rs:1164-1172) ----

    def to_json(self) -> str:
        def cell_d(item: CellItem) -> dict:
            return {
                "kind": item.cell.kind,
                "value": item.cell.value,
                "description": item.description,
                "form": int(item.form),
                "option": item.option,
            }

        return json.dumps(
            {
                "name": self.name,
                "module_type": int(self.module_type),
                "id": self.id,
                "routines": {
                    n: {
                        "name": r.name,
                        "id": r.id,
                        "scale": r.scale,
                        "rotation": r.rotation,
                        "pixelization": r.pixelization,
                        "color_steps": r.color_steps,
                        "row_indents": list(r.grid.row_indents.items()),
                        "cells": [
                            {"coord": list(c), **cell_d(item)}
                            for c, item in r.grid.grid.items()
                        ],
                    }
                    for n, r in self.routines.items()
                },
            }
        )

    @staticmethod
    def from_json(text: str) -> "Module":
        data = json.loads(text)
        m = Module(
            name=data.get("name", ""),
            module_type=ModuleType(data.get("module_type", 1)),
            id=data.get("id", str(uuid_mod.uuid4())),
        )
        for n, rd in data.get("routines", {}).items():
            r = Routine(
                name=rd.get("name", n),
                id=rd.get("id", str(uuid_mod.uuid4())),
                scale=rd.get("scale", 1.0),
                rotation=rd.get("rotation", 0.0),
                pixelization=rd.get("pixelization", 0),
                color_steps=rd.get("color_steps", 0),
            )
            r.grid.row_indents = {int(k): int(v) for k, v in rd.get("row_indents", [])}
            for cd in rd.get("cells", []):
                r.grid.insert(
                    tuple(cd["coord"]),
                    CellItem(
                        cell=Cell(cd["kind"], cd.get("value")),
                        description=cd.get("description", ""),
                        form=CellItemForm(cd.get("form", 1)),
                        option=cd.get("option", 0),
                    ),
                )
            m.routines[n] = r
        return m
