"""Item + Wallet (reference src/server/item.rs, wallet in entity.rs)."""

from __future__ import annotations

import pickle
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Dict, Optional, Set

import numpy as np

from ..map.value import Value, ValueContainer


@dataclass
class Wallet:
    balances: Dict[str, int] = field(default_factory=dict)

    def add(self, currency: str, amount: int) -> None:
        self.balances[currency] = self.balances.get(currency, 0) + amount

    def balance(self, currency: str) -> int:
        return self.balances.get(currency, 0)

    def spend(self, currency: str, amount: int) -> bool:
        if self.balance(currency) >= amount:
            self.balances[currency] -= amount
            return True
        return False


@dataclass
class ItemUpdate:
    """Sparse item delta (item.rs ItemUpdate)."""

    id: int = 0
    attributes: Dict[str, Value] = field(default_factory=dict)
    position: Optional[tuple] = None

    def pack(self) -> bytes:
        return pickle.dumps(self, protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def unpack(data: bytes) -> "ItemUpdate":
        try:
            out = pickle.loads(data)
            if isinstance(out, ItemUpdate):
                return out
        except Exception:
            pass
        return ItemUpdate()


class Item:
    """reference src/server/item.rs — id, attributes, optional light."""

    def __init__(self):
        self.id: int = 0
        self.creator_id: str = str(uuid_mod.uuid4())
        self.position = np.array([0.0, 0.0, 0.0], np.float32)
        self.attributes = ValueContainer()
        self.dirty_attributes: Set[str] = set()
        self.dirty_position: bool = False
        self.light = None

    def get_pos_xz(self) -> np.ndarray:
        return np.array([self.position[0], self.position[2]], np.float32)

    def set_position(self, p) -> None:
        self.position = np.asarray(p, np.float32)
        self.dirty_position = True

    def set_attribute(self, key: str, value) -> None:
        self.attributes.set(key, value)
        self.dirty_attributes.add(key)

    def get_attribute(self, key: str):
        return self.attributes.get(key)

    def name(self) -> str:
        return self.attributes.get_str_default("name", "")

    def is_dirty(self) -> bool:
        return bool(self.dirty_attributes or self.dirty_position)

    def get_update(self) -> ItemUpdate:
        return ItemUpdate(
            id=self.id,
            attributes={
                k: self.attributes.get(k)
                for k in self.dirty_attributes
                if self.attributes.get(k) is not None
            },
            position=tuple(float(x) for x in self.position)
            if self.dirty_position
            else None,
        )

    def clear_dirty(self) -> None:
        self.dirty_attributes.clear()
        self.dirty_position = False

    def apply_update(self, update: ItemUpdate) -> bool:
        if self.id != update.id:
            return False
        rc = False
        if update.position is not None:
            self.position = np.asarray(update.position, np.float32)
        for k, v in update.attributes.items():
            self.attributes._values[k] = v
            if k in ("tile_id", "visible"):
                rc = True
        return rc
