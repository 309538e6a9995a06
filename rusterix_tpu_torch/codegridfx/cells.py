"""Grid cells for the visual code editor (reference codegridfx/lib/src/cell.rs
+ cellitem.rs). A cell is a typed token (value, operator, or function call);
CellItem wraps it with the argument label + form used during code emission.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class ArithmeticOp(enum.IntEnum):
    Add = 0
    Subtract = 1
    Multiply = 2
    Divide = 3

    def to_code(self) -> str:
        return ["+", "-", "*", "/"][self]


class ComparisonOp(enum.IntEnum):
    Equal = 0
    NotEqual = 1
    LessEqual = 2
    GreaterEqual = 3
    Less = 4
    Greater = 5

    def to_code(self) -> str:
        return ["==", "!=", "<=", ">=", "<", ">"][self]


class AssignmentOp(enum.IntEnum):
    Assign = 0
    AddAssign = 1
    SubtractAssign = 2
    MultiplyAssign = 3
    DivideAssign = 4

    def to_code(self) -> str:
        return ["=", "+=", "-=", "*=", "/="][self]


class CellRole(enum.IntEnum):
    NoneRole = 0
    Operator = 1
    Value = 2
    Function = 3
    Event = 4


#: entity-script function cells -> rusteria call names (cell.rs:458-488)
FUNCTION_CELLS = {
    "Action": "action",
    "AddItem": "add_item",
    "BlockEvents": "block_events",
    "CloseIn": "close_in",
    "DealDamage": "deal_damage",
    "Drop": "drop",
    "DropItems": "drop_items",
    "EntitiesInRadius": "entities_in_radius",
    "Equip": "equip",
    "GetAttr": "get_attr",
    "GetAttrOf": "get_attr_of",
    "Goto": "goto",
    "Id": "id",
    "Intent": "intent",
    "InventoryItems": "inventory_items",
    "InventoryItemsOf": "inventory_items_of",
    "Message": "message",
    "NotifyIn": "notify_in",
    "OfferInventory": "offer_inventory",
    "Random": "random",
    "RandomWalk": "random_walk",
    "RandomWalkInSector": "random_walk_in_sector",
    "SetAttr": "set_attr",
    "SetEmitLight": "set_emit_light",
    "SetPlayerCamera": "set_player_camera",
    "SetProximityTracking": "set_proximity_tracking",
    "SetTile": "set_tile",
    "Take": "take",
    "Teleport": "teleport",
    "ToggleAttr": "toggle_attr",
    "TookDamage": "took_damage",
}

#: shader function cells (cell.rs:490-530)
SHADER_FUNCTION_CELLS = {
    n: n.lower()
    for n in (
        "Abs", "Atan", "Atan2", "Ceil", "Clamp", "Cos", "Cross", "Degrees",
        "Dot", "Exp", "Floor", "Fract", "Length", "Log", "Max", "Min", "Mix",
        "Mod", "Normalize", "Pow", "Radians", "Rand", "Rotate2d", "Sign",
        "Sin", "Smoothstep", "Sample", "SampleNormal", "Sqrt", "Step", "Tan",
    )
}
SHADER_FUNCTION_CELLS["SampleNormal"] = "sample_normal"
SHADER_FUNCTION_CELLS["Rotate2d"] = "rotate2d"

ALL_FUNCTIONS = {**FUNCTION_CELLS, **SHADER_FUNCTION_CELLS}


@dataclass
class Cell:
    """Tagged cell; `kind` is one of: Empty, Variable, Integer, Float, Str,
    Boolean, Assignment, Comparison, Arithmetic, If, Else, PaletteColor,
    Value, Textures, LeftParent, RightParent, or a function name from
    FUNCTION_CELLS / SHADER_FUNCTION_CELLS."""

    kind: str = "Empty"
    value: object = None

    def role(self) -> CellRole:
        if self.kind in (
            "Variable", "Integer", "Float", "Str", "Boolean", "Textures",
            "Value", "PaletteColor",
        ):
            return CellRole.Value
        if self.kind in ("Assignment", "Comparison", "Arithmetic", "If", "Else"):
            return CellRole.Operator
        if self.kind in ("Empty", "LeftParent", "RightParent"):
            return CellRole.NoneRole
        if self.kind in ALL_FUNCTIONS:
            return CellRole.Function
        return CellRole.NoneRole

    def to_code(self) -> str:
        """cell.rs:423-530 Cell::to_string."""
        k, v = self.kind, self.value
        if k == "Variable":
            return "id()" if v == "myself" else str(v)
        if k in ("Integer", "Float", "Value", "Textures"):
            return str(v)
        if k == "Boolean":
            return "true" if v else "false"
        if k == "Str":
            s = str(v)
            return s if '"' in s else f'"{s}"'
        if k == "PaletteColor":
            return f"palette({int(v)})"
        if k == "Assignment":
            return "="
        if k == "Comparison":
            return ComparisonOp(v).to_code() if v is not None else "=="
        if k == "Arithmetic":
            return ArithmeticOp(v).to_code() if v is not None else "+"
        if k == "If":
            return "if"
        if k == "Else":
            return "else"
        if k == "LeftParent":
            return "("
        if k == "RightParent":
            return ")"
        if k in ALL_FUNCTIONS:
            return ALL_FUNCTIONS[k]
        return ""


class CellItemForm(enum.IntEnum):
    Box = 0
    Rounded = 1
    LeftRounded = 2
    RightRounded = 3


@dataclass
class CellItem:
    """cellitem.rs — cell + argument label + render form + option index."""

    cell: Cell = field(default_factory=Cell)
    description: str = ""  # non-empty marks a function-argument cell
    form: CellItemForm = CellItemForm.Rounded
    option: int = 0  # Variable: 0 plain / 1 "[0]" / 2 len(); Assignment: op

    def code(self) -> str:
        """cellitem.rs:2011-2040."""
        if self.cell.role() == CellRole.Function:
            return self.cell.to_code() + "("
        if self.cell.kind == "Variable":
            base = self.cell.to_code()
            if self.option == 1:
                return f"{base}[0]"
            if self.option == 2:
                return f"len({base})"
            return base
        if self.cell.kind == "Assignment":
            try:
                return AssignmentOp(self.option).to_code()
            except ValueError:
                return "="
        return self.cell.to_code()


def is_valid_code_variable(name: str) -> bool:
    """cellitem.rs:2042-2055."""
    if not name or not (name[0].isalpha() or name[0] == "_"):
        return False
    return all(c.isalnum() or c in "._" for c in name)
