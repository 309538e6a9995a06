from .cells import (
    ALL_FUNCTIONS,
    ArithmeticOp,
    AssignmentOp,
    Cell,
    CellItem,
    CellItemForm,
    CellRole,
    ComparisonOp,
    FUNCTION_CELLS,
    SHADER_FUNCTION_CELLS,
    is_valid_code_variable,
)
from .module import Grid, Module, ModuleType, Routine

__all__ = [
    "ALL_FUNCTIONS",
    "ArithmeticOp",
    "AssignmentOp",
    "Cell",
    "CellItem",
    "CellItemForm",
    "CellRole",
    "ComparisonOp",
    "FUNCTION_CELLS",
    "SHADER_FUNCTION_CELLS",
    "is_valid_code_variable",
    "Grid",
    "Module",
    "ModuleType",
    "Routine",
]
