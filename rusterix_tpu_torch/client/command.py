"""Client commands (reference src/client/command.rs:5-8)."""

from __future__ import annotations

import enum
from dataclasses import dataclass


class CommandKind(enum.IntEnum):
    CreateEntity = 0
    SetRegion = 1
    StartScreen = 2


@dataclass
class Command:
    kind: CommandKind
    data: object = None
