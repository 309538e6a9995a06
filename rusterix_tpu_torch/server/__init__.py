from .currency import (
    Currencies,
    Currency,
    CurrencyError,
    wallet_add,
    wallet_add_base,
    wallet_balance,
    wallet_can_afford,
    wallet_spend,
)
from .data import apply_entity_data, apply_item_data, read_light
from .collision import (
    BlockingVolume,
    ChunkCollision,
    CollisionWorld,
    DynamicOpening,
    OpeningType,
    WalkableFloor,
)
from .entity import Entity, EntityUpdate
from .item import Item, ItemUpdate, Wallet
from .message import (
    Choice,
    EntityAction,
    EntityActionKind,
    MultipleChoice,
    PlayerCamera,
    RegionMessage,
    RegionMessageKind,
)

__all__ = [
    "Currencies",
    "Currency",
    "CurrencyError",
    "wallet_add",
    "wallet_add_base",
    "wallet_balance",
    "wallet_can_afford",
    "wallet_spend",
    "apply_entity_data",
    "apply_item_data",
    "read_light",
    "BlockingVolume",
    "ChunkCollision",
    "CollisionWorld",
    "DynamicOpening",
    "OpeningType",
    "WalkableFloor",
    "Entity",
    "EntityUpdate",
    "Item",
    "ItemUpdate",
    "Wallet",
    "Choice",
    "EntityAction",
    "EntityActionKind",
    "MultipleChoice",
    "PlayerCamera",
    "RegionMessage",
    "RegionMessageKind",
]
