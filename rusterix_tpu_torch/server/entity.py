"""Entity — the server-side game object with dirty-delta replication.

reference: src/server/entity.rs. The dirty bitmask + sparse `EntityUpdate`
delta protocol (entity.rs:33-41, 458-581, 645-681) is the save-game and
replication format; packing uses a compact binary encoding equivalent to the
reference's bincode payloads.
"""

from __future__ import annotations

import math
import pickle
import random
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np

from ..map.value import Value, ValueContainer
from .item import Item, ItemUpdate, Wallet

DIRTY_POSITION = 0b000001
DIRTY_ORIENTATION = 0b000010
DIRTY_TILT = 0b000100
DIRTY_INVENTORY = 0b001000
DIRTY_EQUIPPED = 0b010000
DIRTY_WALLET = 0b100000


@dataclass
class EntityUpdate:
    """Sparse delta (entity.rs:645-662)."""

    id: int = 0
    creator_id: str = ""
    position: Optional[tuple] = None
    orientation: Optional[tuple] = None
    tilt: Optional[float] = None
    attributes: Dict[str, Value] = field(default_factory=dict)
    inventory_additions: Optional[Dict[int, Item]] = None
    inventory_removals: Optional[Set[int]] = None
    inventory_updates: Optional[Dict[int, ItemUpdate]] = None
    equipped_updates: Optional[Dict[str, Item]] = None
    wallet_updates: Optional[Dict[str, int]] = None

    def pack(self) -> bytes:
        """entity.rs:661-666 (bincode) — compact binary."""
        return pickle.dumps(self, protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def unpack(data: bytes) -> "EntityUpdate":
        try:
            out = pickle.loads(data)
            if isinstance(out, EntityUpdate):
                return out
        except Exception:
            pass
        return EntityUpdate()


class Entity:
    """entity.rs:11-63."""

    def __init__(self):
        self.id: int = 0
        self.creator_id: str = str(uuid_mod.uuid4())
        self.orientation = np.array([1.0, 0.0], np.float32)
        self.position = np.array([0.0, 1.0, 0.0], np.float32)
        self.tilt: float = 0.0
        self.action = None  # EntityAction (server side, not serialized)
        self.attributes = ValueContainer()
        self.dirty_flags: int = 0
        self.dirty_attributes: Set[str] = set()
        self.inventory: List[Optional[Item]] = []
        self.inventory_additions: Dict[int, Item] = {}
        self.inventory_removals: Set[int] = set()
        self.inventory_updates: Dict[int, ItemUpdate] = {}
        self.equipped: Dict[str, Item] = {}
        self.wallet = Wallet()

    # ---- common accessors ----

    def get_mode(self) -> str:
        return self.attributes.get_str_default("mode", "active")

    def get_pos_xz(self) -> np.ndarray:
        return np.array([self.position[0], self.position[2]], np.float32)

    def is_player(self) -> bool:
        return self.attributes.get_bool_default("player", False)

    def get_attr_string(self, key: str, default: str = "") -> str:
        return self.attributes.get_str_default(key, default)

    # ---- mutation with dirty tracking ----

    def set_position(self, p) -> None:
        self.position = np.asarray(p, np.float32)
        self.dirty_flags |= DIRTY_POSITION

    def set_orientation(self, o) -> None:
        self.orientation = np.asarray(o, np.float32)
        self.dirty_flags |= DIRTY_ORIENTATION

    def set_tilt(self, t: float) -> None:
        self.tilt = float(t)
        self.dirty_flags |= DIRTY_TILT

    def set_attribute(self, key: str, value) -> None:
        self.attributes.set(key, value)
        self.dirty_attributes.add(key)

    def get_attribute(self, key: str):
        return self.attributes.get(key)

    # ---- movement helpers (entity.rs:128-177, 583-620) ----

    def forward(self) -> np.ndarray:
        d = self.orientation / max(np.linalg.norm(self.orientation), 1e-12)
        ct, st = math.cos(self.tilt), math.sin(self.tilt)
        v = np.array([d[0] * ct, st, d[1] * ct], np.float32)
        return v / max(np.linalg.norm(v), 1e-12)

    def camera_look_at(self) -> np.ndarray:
        vertical = float(np.linalg.norm(self.orientation)) * math.sin(self.tilt)
        return np.array(
            [
                self.position[0] + self.orientation[0],
                self.position[1] + vertical,
                self.position[2] + self.orientation[1],
            ],
            np.float32,
        )

    def rotate_orientation(self, radians: float) -> None:
        c, s = math.cos(radians), math.sin(radians)
        x, y = self.orientation
        self.set_orientation([x * c - y * s, x * s + y * c])

    def turn_left(self, degrees: float) -> None:
        self.rotate_orientation(-math.radians(degrees))

    def turn_right(self, degrees: float) -> None:
        self.rotate_orientation(math.radians(degrees))

    def move_forward(self, distance: float) -> np.ndarray:
        d = self.orientation / max(np.linalg.norm(self.orientation), 1e-12)
        return self.get_pos_xz() + d * distance

    def move_backward(self, distance: float) -> np.ndarray:
        d = self.orientation / max(np.linalg.norm(self.orientation), 1e-12)
        return self.get_pos_xz() - d * distance

    def move_left(self, distance: float) -> np.ndarray:
        d = self.orientation / max(np.linalg.norm(self.orientation), 1e-12)
        return self.get_pos_xz() + np.array([d[1], -d[0]], np.float32) * distance

    def move_right(self, distance: float) -> np.ndarray:
        d = self.orientation / max(np.linalg.norm(self.orientation), 1e-12)
        return self.get_pos_xz() + np.array([-d[1], d[0]], np.float32) * distance

    def face_east(self):
        self.set_orientation([1.0, 0.0])

    def face_west(self):
        self.set_orientation([-1.0, 0.0])

    def face_north(self):
        self.set_orientation([0.0, -1.0])

    def face_south(self):
        self.set_orientation([0.0, 1.0])

    def face_at(self, target) -> None:
        delta = np.asarray(target, np.float32) - self.get_pos_xz()
        m = float(np.dot(delta, delta))
        if m < 1e-12:
            return
        self.set_orientation(delta / math.sqrt(m))

    def face_random(self) -> None:
        a = random.uniform(0.0, math.tau)
        self.set_orientation([math.cos(a), math.sin(a)])

    def apply_to_camera(self, camera) -> None:
        """Drive a FirstP/Iso camera from the entity (entity.rs:170+)."""
        if camera.id() == "firstp":
            camera.set_parameter_vec3("position", self.position)
            camera.set_parameter_vec3("center", self.camera_look_at())
        elif camera.id() == "iso":
            camera.set_parameter_vec3(
                "center", self.position
            )

    # ---- inventory / equipment ----

    def add_item(self, item: Item) -> Optional[int]:
        for slot, existing in enumerate(self.inventory):
            if existing is None:
                self.inventory[slot] = item
                self.inventory_additions[slot] = item
                self.dirty_flags |= DIRTY_INVENTORY
                return slot
        self.inventory.append(item)
        slot = len(self.inventory) - 1
        self.inventory_additions[slot] = item
        self.dirty_flags |= DIRTY_INVENTORY
        return slot

    def remove_item(self, slot: int) -> Optional[Item]:
        if 0 <= slot < len(self.inventory) and self.inventory[slot] is not None:
            item = self.inventory[slot]
            self.inventory[slot] = None
            self.inventory_removals.add(slot)
            self.dirty_flags |= DIRTY_INVENTORY
            return item
        return None

    def equip(self, slot_name: str, item: Item) -> None:
        self.equipped[slot_name] = item
        self.dirty_flags |= DIRTY_EQUIPPED

    def unequip(self, slot_name: str) -> Optional[Item]:
        item = self.equipped.pop(slot_name, None)
        if item is not None:
            self.dirty_flags |= DIRTY_EQUIPPED
        return item

    def iter_inventory(self):
        for slot, item in enumerate(self.inventory):
            if item is not None:
                yield slot, item

    # reference-named inventory/equipment surface (entity.rs:270-341)

    def get_item(self, item_id: int) -> Optional[Item]:
        """entity.rs:270-277 — look up an inventory item by id."""
        for _, item in self.iter_inventory():
            if item.id == item_id:
                return item
        return None

    def get_item_in_slot(self, slot: int) -> Optional[Item]:
        """entity.rs:286-291."""
        if 0 <= slot < len(self.inventory):
            return self.inventory[slot]
        return None

    def get_item_slot(self, item_id: int) -> Optional[int]:
        """entity.rs:299-306."""
        for slot, item in self.iter_inventory():
            if item.id == item_id:
                return slot
        return None

    def remove_item_from_slot(self, slot: int) -> Optional[Item]:
        """entity.rs slot-keyed removal (our remove_item is already
        slot-keyed; alias for the reference name)."""
        return self.remove_item(slot)

    def equip_item(self, item_id: int, slot_name: str) -> bool:
        """Move an inventory item into an equipment slot, returning any
        previously equipped item to the inventory (entity.rs:309-327)."""
        islot = self.get_item_slot(item_id)
        if islot is None:
            return False
        item = self.remove_item(islot)
        old = self.equipped.pop(slot_name, None)
        if old is not None:
            self.add_item(old)
        self.equip(slot_name, item)
        return True

    def unequip_item(self, slot_name: str) -> bool:
        """Equipment slot -> back into the inventory (entity.rs:330-341)."""
        item = self.unequip(slot_name)
        if item is None:
            return False
        self.add_item(item)
        return True

    def get_equipped_item(self, slot_name: str) -> Optional[Item]:
        return self.equipped.get(slot_name)

    # wallet delegation (entity.rs:343-380) — marks the wallet dirty bit

    def add_currency(self, symbol: str, amount: int, currencies) -> None:
        from .currency import wallet_add

        wallet_add(self.wallet, symbol, amount, currencies)
        self.dirty_flags |= DIRTY_WALLET

    def add_base_currency(self, amount: int, currencies) -> None:
        from .currency import wallet_add_base

        wallet_add_base(self.wallet, amount, currencies)
        self.dirty_flags |= DIRTY_WALLET

    def spend_currency(self, base_amount: int, currencies) -> None:
        from .currency import wallet_spend

        wallet_spend(self.wallet, base_amount, currencies)
        self.dirty_flags |= DIRTY_WALLET

    # position/orientation helpers (entity.rs:152-222)

    def get_forward_pos(self, distance: float):
        """XZ point `distance` ahead along the orientation."""
        return np.array(
            [
                self.position[0] + self.orientation[0] * distance,
                self.position[2] + self.orientation[1] * distance,
            ],
            np.float32,
        )

    def set_pos_xz(self, xz) -> None:
        self.position[0] = float(xz[0])
        self.position[2] = float(xz[1])
        self.dirty_flags |= DIRTY_POSITION

    def set_tilt_from_screen_coordinate(self, screen_y: float) -> None:
        """Map normalized screen y to a -45..45 degree tilt
        (entity.rs:217-222)."""
        self.tilt = (screen_y - 0.5) * 2.0 * (np.pi / 4.0)
        self.dirty_flags |= DIRTY_TILT

    def mark_all_dirty(self) -> None:
        """Force a full delta on the next get_update (entity.rs)."""
        self.dirty_flags = 0b111111
        self.dirty_attributes = set(self.attributes.keys())

    def mark_dirty_attribute(self, key: str) -> None:
        self.dirty_attributes.add(key)

    # ---- delta protocol (entity.rs:458-581) ----

    def is_dirty(self) -> bool:
        return bool(
            self.dirty_flags
            or self.dirty_attributes
            or self.inventory_additions
            or self.inventory_removals
            or self.inventory_updates
        )

    def get_update(self) -> EntityUpdate:
        return EntityUpdate(
            id=self.id,
            creator_id=self.creator_id,
            position=tuple(float(x) for x in self.position)
            if self.dirty_flags & DIRTY_POSITION
            else None,
            orientation=tuple(float(x) for x in self.orientation)
            if self.dirty_flags & DIRTY_ORIENTATION
            else None,
            tilt=self.tilt if self.dirty_flags & DIRTY_TILT else None,
            attributes={
                k: self.attributes.get(k)
                for k in self.dirty_attributes
                if self.attributes.get(k) is not None
            },
            inventory_additions=dict(self.inventory_additions) or None,
            inventory_removals=set(self.inventory_removals) or None,
            inventory_updates=dict(self.inventory_updates) or None,
            equipped_updates=dict(self.equipped)
            if self.dirty_flags & DIRTY_EQUIPPED
            else None,
            wallet_updates=dict(self.wallet.balances)
            if self.dirty_flags & DIRTY_WALLET
            else None,
        )

    def clear_dirty(self) -> None:
        self.dirty_flags = 0
        self.dirty_attributes.clear()
        self.inventory_additions = {}
        self.inventory_removals = set()
        self.inventory_updates = {}

    def apply_update(self, update: EntityUpdate) -> bool:
        """Idempotent delta application; returns True when appearance changed
        (entity.rs:512-581)."""
        if self.id != update.id:
            return False
        rc = False
        self.creator_id = update.creator_id
        if update.position is not None:
            self.position = np.asarray(update.position, np.float32)
        if update.orientation is not None:
            self.orientation = np.asarray(update.orientation, np.float32)
        if update.tilt is not None:
            self.tilt = float(update.tilt)
        for k, v in update.attributes.items():
            self.attributes._values[k] = v
            if k in ("tile_id", "source_seq", "visible", "mode"):
                rc = True
        if update.inventory_additions:
            for slot, item in update.inventory_additions.items():
                while len(self.inventory) <= slot:
                    self.inventory.append(None)
                self.inventory[slot] = item
        if update.inventory_removals:
            for slot in update.inventory_removals:
                if 0 <= slot < len(self.inventory):
                    self.inventory[slot] = None
        if update.inventory_updates:
            for slot, iu in update.inventory_updates.items():
                if 0 <= slot < len(self.inventory) and self.inventory[slot] is not None:
                    self.inventory[slot].apply_update(iu)
        if update.equipped_updates is not None:
            self.equipped = dict(update.equipped_updates)
            rc = True
        if update.wallet_updates is not None:
            self.wallet.balances = dict(update.wallet_updates)
        return rc

    # serde analogue
    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "creator_id": self.creator_id,
            "orientation": [float(x) for x in self.orientation],
            "position": [float(x) for x in self.position],
            "tilt": self.tilt,
            "attributes": {k: v.to_python() for k, v in self.attributes.items()},
        }
