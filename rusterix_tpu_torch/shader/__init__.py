"""The rusteria shader compiler in torch (the JAX package's `shader`
package): `jaxc` evaluates a shader's AST over a pixel grid with torch
operations, `patterns` holds the procedural pattern bank and its sampler."""

from .jaxc import CompileError, Evaluator, Program, Rusteria, Val
from .patterns import PATTERN_NAMES, pattern_bank

__all__ = [
    "CompileError",
    "Evaluator",
    "Program",
    "Rusteria",
    "Val",
    "PATTERN_NAMES",
    "pattern_bank",
]
