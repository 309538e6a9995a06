"""Server <-> region wire protocol (reference src/server/message.rs)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class EntityActionKind(enum.IntEnum):
    """reference src/server/message.rs:47-74"""

    Off = 0
    Forward = 1
    Backward = 2
    Left = 3
    Right = 4
    Goto = 5
    CloseIn = 6
    RandomWalk = 7
    RandomWalkInSector = 8
    SleepAndSwitch = 9
    Intent = 10
    Choice = 11  # a multiple-choice entry the user selected (message.rs:73)


@dataclass
class EntityAction:
    kind: EntityActionKind = EntityActionKind.Off
    target: Optional[tuple] = None  # Goto / CloseIn target xz
    speed: float = 1.0
    distance: float = 0.0  # CloseIn stop distance
    until: float = 0.0  # SleepAndSwitch wake time
    next_action: Optional["EntityAction"] = None
    # random-walk state
    max_sleep: float = 2.0
    state_time: float = 0.0
    string: str = ""  # Intent payload
    choice: Optional["Choice"] = None  # Choice payload (message.rs:73)

    @staticmethod
    def from_str(value: str) -> Optional["EntityAction"]:
        """message.rs:86-100."""
        kind = {
            "none": EntityActionKind.Off,
            "left": EntityActionKind.Left,
            "forward": EntityActionKind.Forward,
            "right": EntityActionKind.Right,
            "backward": EntityActionKind.Backward,
        }.get(value)
        return EntityAction(kind) if kind is not None else None

    def display(self) -> str:
        return {
            EntityActionKind.Off: "none",
            EntityActionKind.Left: "left",
            EntityActionKind.Forward: "forward",
            EntityActionKind.Right: "right",
            EntityActionKind.Backward: "backward",
        }.get(self.kind, "none")


class PlayerCamera(enum.IntEnum):
    """reference src/server/message.rs:77"""

    D2 = 0
    D3Iso = 1
    D3FirstP = 2


@dataclass
class Choice:
    """reference message.rs:133-138: Cancel(from, to) | ItemToSell(item_id,
    seller_id, buyer_id)."""

    kind: str = "cancel"  # "cancel" | "item_to_sell"
    item_id: int = 0
    seller_id: int = 0
    buyer_id: int = 0
    from_id: int = 0
    to_id: int = 0

    @staticmethod
    def cancel(from_id: int, to_id: int) -> "Choice":
        return Choice(kind="cancel", from_id=from_id, to_id=to_id)

    @staticmethod
    def item_to_sell(item_id: int, seller_id: int, buyer_id: int) -> "Choice":
        return Choice(
            kind="item_to_sell",
            item_id=item_id,
            seller_id=seller_id,
            buyer_id=buyer_id,
        )


@dataclass
class MultipleChoice:
    """reference message.rs:140-152: region + from/to entity + entries."""

    region: int = 0
    sender: int = 0  # `from` in the reference
    receiver: int = 0  # `to`
    choices: List[Choice] = field(default_factory=list)

    def add(self, choice: Choice) -> None:
        self.choices.append(choice)


class RegionMessageKind(enum.IntEnum):
    """reference src/server/message.rs:8-44"""

    RegisterPlayer = 0
    Event = 1
    UserEvent = 2
    UserAction = 3
    CreateEntity = 4
    EntitiesUpdate = 5
    ItemsUpdate = 6
    RemoveItem = 7
    LogMessage = 8
    Time = 9
    Message = 10
    TransferEntity = 11
    MultipleChoice = 12
    DebugData = 13
    Pause = 14
    Continue = 15
    Quit = 16


@dataclass
class RegionMessage:
    kind: RegionMessageKind
    region_id: int = 0
    entity_id: int = 0
    data: object = None  # payload (kind-specific)

    # convenience constructors
    @staticmethod
    def event(region_id, entity_id, name, value=None):
        return RegionMessage(
            RegionMessageKind.Event, region_id, entity_id, (name, value)
        )

    @staticmethod
    def user_event(region_id, entity_id, name, value=None):
        return RegionMessage(
            RegionMessageKind.UserEvent, region_id, entity_id, (name, value)
        )

    @staticmethod
    def user_action(region_id, entity_id, action):
        return RegionMessage(
            RegionMessageKind.UserAction, region_id, entity_id, action
        )

    @staticmethod
    def entities_update(region_id, packed_updates: list):
        return RegionMessage(
            RegionMessageKind.EntitiesUpdate, region_id, data=packed_updates
        )

    @staticmethod
    def items_update(region_id, packed_updates: list):
        return RegionMessage(
            RegionMessageKind.ItemsUpdate, region_id, data=packed_updates
        )

    @staticmethod
    def log(region_id, text: str):
        return RegionMessage(RegionMessageKind.LogMessage, region_id, data=text)

    @staticmethod
    def time(region_id, time_value):
        return RegionMessage(RegionMessageKind.Time, region_id, data=time_value)

    @staticmethod
    def message(region_id, sender, receiver, text, category=""):
        return RegionMessage(
            RegionMessageKind.Message, region_id, data=(sender, receiver, text, category)
        )

    @staticmethod
    def transfer_entity(region_id, entity, dest_region_name, dest_pos):
        return RegionMessage(
            RegionMessageKind.TransferEntity,
            region_id,
            data=(entity, dest_region_name, dest_pos),
        )
