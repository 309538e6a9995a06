"""Region instance — one running map simulation.

reference: src/server/region.rs (RegionInstance: script compilation, tick
loops, EntityAction state machines, collision-applied movement, delta
sending) + src/server/regionctx.rs (RegionCtx) + src/server/region_host.rs
(the ~70 script host calls).
"""

from __future__ import annotations

import math
import queue
import random
import tomllib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..builders.chunk import CHUNK_SIZE
from ..map.mini import MapMini
from ..vm import VM, Execution, HostHandler, VMValue
from .collision import BlockingVolume, ChunkCollision, CollisionWorld
from .currency import Currencies, Currency
from .entity import Entity
from .item import Item
from .message import (
    Choice,
    EntityAction,
    EntityActionKind,
    MultipleChoice,
    RegionMessage,
    RegionMessageKind,
)


def _default_currencies() -> Currencies:
    """Gold as the base denomination, installed at region init
    (region.rs:387-395)."""
    c = Currencies(base_currency="G")
    c.add_currency(Currency(name="Gold", symbol="G", exchange_rate=1.0))
    return c


@dataclass
class Notification:
    at_time: float
    entity_id: int
    event: str
    value: object = None


def _new_debug_module():
    from ..codegridfx.debugmodule import DebugModule

    return DebugModule()


@dataclass
class RegionCtx:
    """reference src/server/regionctx.rs:11-69."""

    region_id: int = 0
    name: str = ""
    map: object = None
    mapmini: MapMini = field(default_factory=MapMini)
    collision_world: CollisionWorld = field(default_factory=CollisionWorld)
    entities: List[Entity] = field(default_factory=list)
    items: List[Item] = field(default_factory=list)
    entity_programs: Dict[str, object] = field(default_factory=dict)  # class -> VMProgram
    item_programs: Dict[str, object] = field(default_factory=dict)
    entity_class_data: Dict[str, dict] = field(default_factory=dict)
    item_class_data: Dict[str, dict] = field(default_factory=dict)
    notifications: List[Notification] = field(default_factory=list)
    #: stripped map player entities, reused as spawn templates when a real
    #: player joins (the reference re-homes joining players onto them)
    player_spawns: List[Entity] = field(default_factory=list)
    proximity_tracking: Dict[int, float] = field(default_factory=dict)
    blocked_events: Dict[Tuple[int, str], float] = field(default_factory=dict)
    #: denomination registry; Gold installed at region init (region.rs:387-395)
    currencies: "Currencies" = field(default_factory=lambda: _default_currencies())
    config: dict = field(default_factory=dict)
    startup_errors: List[str] = field(default_factory=list)
    game_time: float = 8.0 * 60.0  # minutes of day
    ticks: int = 0
    debug_mode: bool = False
    #: codegridfx debug location from set_debug_loc (region_host.rs:106-116)
    curr_debug_loc: Optional[Tuple[str, int, int]] = None
    #: per-cell runtime values captured while debug_mode is on
    #: (codegridfx/lib/src/debugmodule.rs; streamed via DebugData)
    debug: "DebugModule" = field(default_factory=lambda: _new_debug_module())


class RegionHost(HostHandler):
    """Script host-call handler (reference src/server/region_host.rs:30+)."""

    def __init__(self, region: "RegionInstance"):
        super().__init__()
        self.region = region
        self.entity: Optional[Entity] = None  # current script subject

    def _debug(self, value, error: bool = False) -> None:
        """Record a value at the current codegridfx cell
        (reference src/server/region.rs:2514 add_debug_value)."""
        ctx = self.region.ctx
        if not ctx.debug_mode or ctx.curr_debug_loc is None:
            return
        event, x, y = ctx.curr_debug_loc
        eid = self.entity.id if self.entity is not None else 0
        ctx.debug.add_value(eid, event, x, y, value)
        if error:
            ctx.debug.add_error(eid, event, x, y)
        else:
            ctx.debug.remove_error(eid, event, x, y)

    def on_host_call(self, name: str, args: List[VMValue], vm: Execution) -> VMValue:
        handler = getattr(self, f"h_{name}", None)
        if handler is not None:
            return handler(args, vm)
        # unknown calls are recorded (debuggable, like LogMessage)
        self.outputs[name] = args[0] if args else VMValue.zero()
        return VMValue.zero()

    # -- movement --

    def h_action(self, args, vm) -> VMValue:
        name = args[0].as_string() or ""
        self.outputs["action"] = args[0]
        e = self.entity
        if e is None:
            return VMValue.zero()
        kind = {
            "forward": EntityActionKind.Forward,
            "backward": EntityActionKind.Backward,
            "left": EntityActionKind.Left,
            "right": EntityActionKind.Right,
            "none": EntityActionKind.Off,
            "off": EntityActionKind.Off,
        }.get(name, EntityActionKind.Off)
        e.action = EntityAction(kind)
        return VMValue.zero()

    def h_goto(self, args, vm) -> VMValue:
        e = self.entity
        if e is None:
            return VMValue.zero()
        if len(args) >= 2 and args[0].s is None:
            target = (args[0].x, args[1].x)
            speed = args[2].x if len(args) > 2 else 1.0
        else:
            # goto("sector name", speed)
            sec = self._sector_by_name(args[0].as_string() or "")
            if sec is None:
                return VMValue.broadcast(0.0)
            c = sec.center(self.region.ctx.map)
            target = (float(c[0]), float(c[1]))
            speed = args[1].x if len(args) > 1 else 1.0
        e.action = EntityAction(EntityActionKind.Goto, target=target, speed=speed)
        return VMValue.broadcast(1.0)

    def h_close_in(self, args, vm) -> VMValue:
        e = self.entity
        if e is None:
            return VMValue.zero()
        target_id = int(args[0].x)
        distance = args[1].x if len(args) > 1 else 1.0
        speed = args[2].x if len(args) > 2 else 1.0
        target = self.region.find_entity(target_id)
        if target is None:
            return VMValue.broadcast(0.0)
        e.action = EntityAction(
            EntityActionKind.CloseIn,
            target=(int(target_id),),
            distance=distance,
            speed=speed,
        )
        return VMValue.broadcast(1.0)

    def h_random_walk(self, args, vm) -> VMValue:
        e = self.entity
        if e is None:
            return VMValue.zero()
        distance = args[0].x if len(args) > 0 else 2.0
        speed = args[1].x if len(args) > 1 else 1.0
        max_sleep = args[2].x if len(args) > 2 else 2.0
        e.action = EntityAction(
            EntityActionKind.RandomWalk,
            distance=distance,
            speed=speed,
            max_sleep=max_sleep,
        )
        return VMValue.zero()

    def h_random_walk_in_sector(self, args, vm) -> VMValue:
        v = self.h_random_walk(args, vm)
        if self.entity is not None and self.entity.action is not None:
            self.entity.action.kind = EntityActionKind.RandomWalkInSector
        return v

    def h_teleport(self, args, vm) -> VMValue:
        e = self.entity
        if e is None:
            return VMValue.zero()
        if args and args[0].s is not None:
            sec = self._sector_by_name(args[0].s)
            if sec is not None:
                c = sec.center(self.region.ctx.map)
                e.set_position([float(c[0]), e.position[1], float(c[1])])
        elif len(args) >= 2:
            e.set_position([args[0].x, e.position[1], args[1].x])
        return VMValue.zero()

    # -- attributes --

    def h_set_attr(self, args, vm) -> VMValue:
        if self.entity is not None and args:
            key = args[0].as_string() or ""
            val = args[1] if len(args) > 1 else VMValue.zero()
            self.entity.set_attribute(key, val.s if val.s is not None else val.x)
        return VMValue.zero()

    def h_id(self, args, vm) -> VMValue:
        """region_host.rs "id": the current script subject's id."""
        if self.entity is not None:
            return VMValue.broadcast(float(self.entity.id))
        return VMValue.zero()

    def h_is_entity(self, args, vm) -> VMValue:
        """region_host.rs:703-709."""
        if not args:
            return VMValue.broadcast(0.0)
        eid = int(args[0].x)
        exists = any(e.id == eid for e in self.region.ctx.entities)
        return VMValue.broadcast(1.0 if exists else 0.0)

    def h_is_item(self, args, vm) -> VMValue:
        """region_host.rs:689-702: world items OR items in any inventory."""
        if not args:
            return VMValue.broadcast(0.0)
        iid = int(args[0].x)
        exists = any(i.id == iid for i in self.region.ctx.items) or any(
            item is not None and item.id == iid
            for e in self.region.ctx.entities
            for item in e.inventory
        )
        return VMValue.broadcast(1.0 if exists else 0.0)

    def h_distance_to(self, args, vm) -> VMValue:
        """region_host.rs:710-732: distance from the subject to an
        entity/item id."""
        if self.entity is None or not args:
            return VMValue.zero()
        target = int(args[0].x)
        pos = None
        for e in self.region.ctx.entities:
            if e.id == target:
                pos = e.get_pos_xz()
                break
        if pos is None:
            for i in self.region.ctx.items:
                if i.id == target:
                    pos = i.get_pos_xz()
                    break
        if pos is None:
            return VMValue.zero()
        return VMValue.broadcast(
            float(np.linalg.norm(self.entity.get_pos_xz() - pos))
        )

    def h_list_get(self, args, vm) -> VMValue:
        """region_host.rs:668-687: index a comma-separated list string."""
        if not args:
            return VMValue.zero()
        s = args[0].as_string() or ""
        idx = int(args[1].x) if len(args) > 1 else 0
        parts = [p for p in s.split(",") if p]
        if 0 <= idx < len(parts):
            return VMValue.from_string(parts[idx])
        return VMValue.zero()

    def h_drop_items(self, args, vm) -> VMValue:
        """region_host.rs:900-950: drop every inventory item whose name or
        class matches the filter (empty filter = all)."""
        if self.entity is None:
            return VMValue.zero()
        filt = (args[0].as_string() or "") if args else ""
        slots = []
        for slot, item in enumerate(self.entity.inventory):
            if item is None:
                continue
            name = item.attributes.get_str_default("name", "")
            cls = item.attributes.get_str_default("class_name", "")
            if not filt or filt in name or filt in cls:
                slots.append(slot)
        for slot in slots:
            removed = self.entity.remove_item(slot)
            if removed is not None:
                removed.set_position(self.entity.position.copy())
                self.region.ctx.items.append(removed)
        return VMValue.zero()

    def h_set_debug_loc(self, args, vm) -> VMValue:
        """region_host.rs:106-116: record the codegridfx debug location."""
        if len(args) >= 3:
            self.region.ctx.curr_debug_loc = (
                args[0].as_string() or "",
                int(args[1].x),
                int(args[2].x),
            )
        return VMValue.zero()

    def h_get_attr(self, args, vm) -> VMValue:
        if self.entity is None or not args:
            return VMValue.zero()
        key = args[0].as_string() or ""
        v = self.entity.attributes.get(key)
        if v is None:
            return VMValue.zero()
        data = v.to_python()
        if isinstance(data, str):
            return VMValue.from_string(data)
        try:
            return VMValue.broadcast(float(data))
        except (TypeError, ValueError):
            return VMValue.zero()

    def h_toggle_attr(self, args, vm) -> VMValue:
        if self.entity is not None and args:
            key = args[0].as_string() or ""
            cur = self.entity.attributes.get_bool_default(key, False)
            self.entity.set_attribute(key, not cur)
        return VMValue.zero()

    def h_get_attr_of(self, args, vm) -> VMValue:
        if len(args) < 2:
            return VMValue.zero()
        other = self.region.find_entity(int(args[0].x))
        if other is None:
            return VMValue.zero()
        saved, self.entity = self.entity, other
        try:
            return self.h_get_attr(args[1:], vm)
        finally:
            self.entity = saved

    # -- combat / inventory --

    def h_deal_damage(self, args, vm) -> VMValue:
        if len(args) < 2:
            return VMValue.zero()
        target = self.region.find_entity(int(args[0].x))
        amount = args[1].x
        if target is not None:
            self.region.queue_event(target.id, "took_damage", amount)
        return VMValue.zero()

    def h_add_item(self, args, vm) -> VMValue:
        if self.entity is None or not args:
            return VMValue.broadcast(-1.0)
        from .data import apply_item_data

        item = Item()
        item.id = self.region.next_item_id()
        item.set_attribute("name", args[0].as_string() or "")
        class_name = args[0].as_string() or ""
        apply_item_data(item, self.region.ctx.item_class_data.get(class_name, {}))
        slot = self.entity.add_item(item)
        self._debug("Ok" if slot is not None else "Inventory Full",
                    error=slot is None)
        return VMValue.broadcast(float(slot if slot is not None else -1))

    def h_equip(self, args, vm) -> VMValue:
        if self.entity is None or len(args) < 1:
            return VMValue.zero()
        slot = int(args[0].x)
        item = self.entity.remove_item(slot)
        if item is not None:
            slot_name = item.attributes.get_str_default("slot", "hand")
            self.entity.equip(slot_name, item)
            self._debug("Ok")
        else:
            self._debug("Unknown Item", error=True)
        return VMValue.zero()

    def h_drop(self, args, vm) -> VMValue:
        if self.entity is None or not args:
            return VMValue.zero()
        item = self.entity.remove_item(int(args[0].x))
        if item is not None:
            item.set_position(self.entity.position.copy())
            self.region.ctx.items.append(item)
        return VMValue.zero()

    def h_take(self, args, vm) -> VMValue:
        if self.entity is None or not args:
            return VMValue.broadcast(0.0)
        item_id = int(args[0].x)
        for i, item in enumerate(self.region.ctx.items):
            if item.id == item_id:
                self.region.ctx.items.pop(i)
                self.entity.add_item(item)
                return VMValue.broadcast(1.0)
        return VMValue.broadcast(0.0)

    def h_inventory_items(self, args, vm) -> VMValue:
        if self.entity is None:
            return VMValue.broadcast(0.0)
        return VMValue.broadcast(float(sum(1 for _ in self.entity.iter_inventory())))

    def h_inventory_items_of(self, args, vm) -> VMValue:
        if self.entity is None or not args:
            return VMValue.broadcast(0.0)
        name = args[0].as_string() or ""
        return VMValue.broadcast(
            float(
                sum(1 for _, it in self.entity.iter_inventory() if it.name() == name)
            )
        )

    # -- world / misc --

    def h_set_tile(self, args, vm) -> VMValue:
        if self.entity is not None and args:
            self.entity.set_attribute("source_seq", args[0].as_string() or "")
        return VMValue.zero()

    def h_set_emit_light(self, args, vm) -> VMValue:
        if self.entity is not None and args:
            self.entity.set_attribute("emit_light", args[0].x)
        return VMValue.zero()

    def h_set_rig_sequence(self, args, vm) -> VMValue:
        if self.entity is not None and args:
            self.entity.set_attribute("rig_sequence", args[0].as_string() or "")
        return VMValue.zero()

    def h_set_player_camera(self, args, vm) -> VMValue:
        if self.entity is not None and args:
            self.entity.set_attribute("player_camera", args[0].as_string() or "")
        return VMValue.zero()

    def h_set_proximity_tracking(self, args, vm) -> VMValue:
        if self.entity is not None and args:
            radius = args[0].x
            if radius > 0:
                self.region.ctx.proximity_tracking[self.entity.id] = radius
            else:
                self.region.ctx.proximity_tracking.pop(self.entity.id, None)
        return VMValue.zero()

    def h_entities_in_radius(self, args, vm) -> VMValue:
        if self.entity is None:
            return VMValue.broadcast(0.0)
        radius = args[0].x if args else 2.0
        me = self.entity.get_pos_xz()
        count = 0
        for e in self.region.ctx.entities:
            if e.id == self.entity.id:
                continue
            if float(np.linalg.norm(e.get_pos_xz() - me)) <= radius:
                count += 1
        return VMValue.broadcast(float(count))

    def h_notify_in(self, args, vm) -> VMValue:
        if self.entity is None or len(args) < 2:
            return VMValue.zero()
        minutes = args[0].x
        event = args[1].as_string() or ""
        self.region.ctx.notifications.append(
            Notification(
                at_time=self.region.ctx.game_time + minutes,
                entity_id=self.entity.id,
                event=event,
            )
        )
        return VMValue.zero()

    def h_block_events(self, args, vm) -> VMValue:
        if self.entity is not None and len(args) >= 2:
            event = args[0].as_string() or ""
            minutes = args[1].x
            self.region.ctx.blocked_events[(self.entity.id, event)] = (
                self.region.ctx.game_time + minutes
            )
        return VMValue.zero()

    def h_message(self, args, vm) -> VMValue:
        text = args[0].display() if args else ""
        category = args[1].as_string() if len(args) > 1 else ""
        self.region.out_messages.append(
            RegionMessage.message(
                self.region.ctx.region_id,
                self.entity.id if self.entity else 0,
                -1,
                text,
                category or "",
            )
        )
        self._debug("Ok")
        return VMValue.zero()

    def h_intent(self, args, vm) -> VMValue:
        if self.entity is not None and args:
            self.entity.set_attribute("intent", args[0].as_string() or "")
        return VMValue.zero()

    def h_debug(self, args, vm) -> VMValue:
        text = " ".join(a.display() for a in args)
        self.region.out_messages.append(
            RegionMessage.log(self.region.ctx.region_id, text)
        )
        self._debug(text)
        return VMValue.zero()

    def h_random(self, args, vm) -> VMValue:
        lo = args[0].x if args else 0.0
        hi = args[1].x if len(args) > 1 else 1.0
        return VMValue.broadcast(random.uniform(lo, hi))

    def h_get_entity_id(self, args, vm) -> VMValue:
        return VMValue.broadcast(float(self.entity.id) if self.entity else -1.0)

    def h_took_damage(self, args, vm) -> VMValue:
        return VMValue.zero()

    def h_offer_inventory(self, args, vm) -> VMValue:
        """offer_inventory(to, filter) — offer the current entity's matching
        inventory to entity `to` as a MultipleChoice (region_host.rs:863-898):
        filter is a substring match on item name or class_name; empty matches
        all."""
        if self.entity is None or not args:
            return VMValue.zero()
        to = int(args[0].x)
        filt = args[1].as_string() if len(args) > 1 else ""
        filt = filt or ""
        choices = MultipleChoice(
            region=self.region.ctx.region_id,
            sender=self.entity.id,
            receiver=to,
        )
        for _, item in self.entity.iter_inventory():
            name = item.attributes.get_str_default("name", "")
            class_name = item.attributes.get_str_default("class_name", "")
            if not filt or filt in name or filt in class_name:
                choices.add(Choice.item_to_sell(item.id, self.entity.id, to))
        self.region.out_messages.append(
            RegionMessage(
                RegionMessageKind.MultipleChoice,
                self.region.ctx.region_id,
                data=choices,
            )
        )
        return VMValue.zero()

    def _sector_by_name(self, name: str):
        m = self.region.ctx.map
        if m is None:
            return None
        for s in m.sectors:
            if s.name == name:
                return s
        return None


class RegionInstance:
    """reference src/server/region.rs:69+."""

    GAME_TICK_MINUTES = 1.0
    REDRAW_DELTA = 1.0 / 30.0

    def __init__(self, region_id: int, name: str = ""):
        self.ctx = RegionCtx(region_id=region_id, name=name)
        self.vm = VM()
        self.host = RegionHost(self)
        self.inbox: "queue.Queue[RegionMessage]" = queue.Queue()
        self.outbox: "queue.Queue[RegionMessage]" = queue.Queue()
        self.out_messages: List[RegionMessage] = []
        self.paused = False
        self.running = True
        self._next_entity_id = 0
        self._next_item_id = 0

    # ---- init (region.rs:366-560) ----

    def init(self, map_, entities: Dict[str, tuple], items: Dict[str, tuple], config: str = "") -> None:
        self.ctx.map = map_
        self.ctx.mapmini = map_.as_mini()
        self._build_collision(map_)

        if config:
            try:
                self.ctx.config = tomllib.loads(config)
            except Exception as e:
                self.ctx.startup_errors.append(f"config: {e}")

        for class_name, (source, data) in entities.items():
            try:
                self.ctx.entity_programs[class_name] = self._compile_entity_source(source)
            except Exception as e:
                self.ctx.startup_errors.append(f"{class_name}: {e}")
            if data:
                try:
                    self.ctx.entity_class_data[class_name] = tomllib.loads(data)
                except Exception as e:
                    self.ctx.startup_errors.append(f"{class_name}.toml: {e}")

        for class_name, (source, data) in items.items():
            try:
                if source.strip():
                    self.ctx.item_programs[class_name] = self._compile_entity_source(source)
            except Exception as e:
                self.ctx.startup_errors.append(f"{class_name}: {e}")
            if data:
                try:
                    self.ctx.item_class_data[class_name] = tomllib.loads(data)
                except Exception as e:
                    self.ctx.startup_errors.append(f"{class_name}.toml: {e}")

        # instantiate map entities; players are stripped (created on join,
        # region.rs:366-560)
        for entity in list(map_.entities):
            class_name = entity.get_attr_string("class_name")
            data = self.ctx.entity_class_data.get(class_name, {})
            attrs = data.get("attributes", {})
            is_player = bool(attrs.get("player", False))
            if is_player:
                self.ctx.player_spawns.append(entity)
                continue
            self._seed_inventory_and_wallet(entity)
            self.spawn_entity(entity)

    def restore_entities(self, saved: list) -> None:
        """Apply a save-game entity snapshot (map/persist.entity_to_json
        dicts) over the live region: position/orientation/tilt, attributes,
        inventory, equipment, wallet. Matched by entity id; unmatched saves
        are added. Everything is marked dirty so mirrors resync on the next
        redraw tick (the reference reloads serde-saved entities the same
        way: full state in, delta protocol out)."""
        from ..map.persist import entity_from_json
        from .entity import (
            DIRTY_EQUIPPED,
            DIRTY_INVENTORY,
            DIRTY_ORIENTATION,
            DIRTY_POSITION,
            DIRTY_TILT,
            DIRTY_WALLET,
        )

        all_dirty = (
            DIRTY_POSITION | DIRTY_ORIENTATION | DIRTY_TILT
            | DIRTY_INVENTORY | DIRTY_EQUIPPED | DIRTY_WALLET
        )
        by_id = {e.id: e for e in self.ctx.entities}
        for d in saved:
            restored = entity_from_json(d)
            live = by_id.get(restored.id)
            if live is None:
                self.ctx.entities.append(restored)
                live = restored
            else:
                live.position = restored.position
                live.orientation = restored.orientation
                live.tilt = restored.tilt
                live.attributes = restored.attributes
                live.inventory = restored.inventory
                live.equipped = restored.equipped
                live.wallet = restored.wallet
            live.dirty_flags |= all_dirty
            live.dirty_attributes |= set(live.attributes.keys())

    def _build_collision(self, map_) -> None:
        cw = CollisionWorld(CHUNK_SIZE)
        per_chunk: Dict[Tuple[int, int], ChunkCollision] = {}
        for linedef in map_.linedefs:
            h = linedef.properties.get_float_default("wall_height", 0.0)
            if h <= 0:
                continue
            v0 = map_.get_vertex(linedef.start_vertex)
            v1 = map_.get_vertex(linedef.end_vertex)
            if v0 is None or v1 is None:
                continue
            w = max(linedef.properties.get_float_default("wall_width", 0.0), 0.05)
            mnx, mxx = min(v0.x, v1.x) - w / 2, max(v0.x, v1.x) + w / 2
            mny, mxy = min(v0.y, v1.y) - w / 2, max(v0.y, v1.y) + w / 2
            key = (int(math.floor((mnx + mxx) / 2 / CHUNK_SIZE)), int(math.floor((mny + mxy) / 2 / CHUNK_SIZE)))
            chunk = per_chunk.setdefault(key, ChunkCollision())
            chunk.static_volumes.append(
                BlockingVolume(
                    geo_id=("linedef", linedef.id),
                    min=np.array([mnx, 0.0, mny], np.float32),
                    max=np.array([mxx, h, mxy], np.float32),
                )
            )
        for key, chunk in per_chunk.items():
            cw.update_chunk(key, chunk)
        self.ctx.collision_world = cw

    # ---- entity management ----

    def next_item_id(self) -> int:
        self._next_item_id += 1
        return self._next_item_id - 1

    def _compile_entity_source(self, source: str):
        """Compile an entity/item script: the src/vm language by default, or
        the Python class dialect the shipped minigame .rxe files use (the
        reference's RustPython engine, region.rs:94-160 — commented out
        there, executed natively here; see server/pyscript.py)."""
        from .pyscript import PythonEntityProgram, looks_like_python_dialect

        if looks_like_python_dialect(source):
            return PythonEntityProgram(source, self)
        return self.vm.compile(self.vm.parse_str(source))

    def _seed_inventory_and_wallet(self, entity: Entity) -> None:
        """Size the inventory and fund the wallet from the entity's
        `inventory_slots` / `wealth` attributes (region.rs:670-681)."""
        slots = entity.attributes.get_int_default("inventory_slots", 0)
        if slots > 0:
            entity.inventory = [None] * slots
        wealth = entity.attributes.get_int_default("wealth", 0)
        if wealth > 0:
            entity.add_base_currency(wealth, self.ctx.currencies)

    def spawn_entity(self, entity: Entity) -> Entity:
        entity.id = self._next_entity_id
        self._next_entity_id += 1
        self.ctx.entities.append(entity)
        self.run_entity_event(entity, "startup", None)
        return entity

    def create_entity_instance(self, class_name: str, position=None) -> Entity:
        """region.rs:2079."""
        entity = Entity()
        entity.set_attribute("class_name", class_name)
        # inherit the map's spawn template (position, name, tile) if present
        for spawn in self.ctx.player_spawns:
            if spawn.get_attr_string("class_name") == class_name:
                entity.set_position(spawn.position.copy())
                entity.set_orientation(spawn.orientation.copy())
                for k, v in spawn.attributes.items():
                    entity.attributes._values[k] = v
                    entity.dirty_attributes.add(k)
                break
        from .data import apply_entity_data

        apply_entity_data(entity, self.ctx.entity_class_data.get(class_name, {}))
        if position is not None:
            entity.set_position(position)
        # joining players get the same inventory/wallet seeding as map
        # entities (region.rs:2100-2112)
        self._seed_inventory_and_wallet(entity)
        return self.spawn_entity(entity)

    def find_entity(self, entity_id: int) -> Optional[Entity]:
        for e in self.ctx.entities:
            if e.id == entity_id:
                return e
        return None

    # ---- script dispatch (region_host.rs:1151-1177) ----

    def run_entity_event(self, entity: Entity, event: str, value) -> None:
        deadline = self.ctx.blocked_events.get((entity.id, event))
        if deadline is not None and self.ctx.game_time < deadline:
            return
        class_name = entity.get_attr_string("class_name")
        program = self.ctx.entity_programs.get(class_name)
        if program is None or "event" not in program.functions:
            return
        self.host.entity = entity
        try:
            from .pyscript import PythonEntityProgram

            if isinstance(program, PythonEntityProgram):
                program.call("event", entity.id, event, value)
            else:
                ex = Execution(program, self.host)
                args = [VMValue.from_string(event), _to_vmvalue(value)]
                ex.execute_function(args, "event")
        except Exception as e:
            self.outbox.put(
                RegionMessage.log(self.ctx.region_id, f"script error: {e}")
            )
        self.host.entity = None

    def run_user_event(self, entity: Entity, event: str, value) -> None:
        class_name = entity.get_attr_string("class_name")
        program = self.ctx.entity_programs.get(class_name)
        if program is None or "user_event" not in program.functions:
            return
        self.host.entity = entity
        try:
            from .pyscript import PythonEntityProgram

            if isinstance(program, PythonEntityProgram):
                program.call("user_event", entity.id, event, value)
            else:
                ex = Execution(program, self.host)
                ex.execute_function(
                    [VMValue.from_string(event), _to_vmvalue(value)], "user_event"
                )
        except Exception as e:
            self.outbox.put(
                RegionMessage.log(self.ctx.region_id, f"script error: {e}")
            )
        self.host.entity = None

    def queue_event(self, entity_id: int, event: str, value) -> None:
        self.inbox.put(
            RegionMessage.event(self.ctx.region_id, entity_id, event, value)
        )

    # ---- ticks (region.rs:945-1082) ----

    def system_tick(self) -> None:
        if self.paused or not self.running:
            return
        self.ctx.game_time += self.GAME_TICK_MINUTES
        self.ctx.ticks += 1
        self.outbox.put(RegionMessage.time(self.ctx.region_id, self.ctx.game_time))

        # due notifications -> script `event(...)` (region.rs:967-996)
        due = [n for n in self.ctx.notifications if n.at_time <= self.ctx.game_time]
        self.ctx.notifications = [
            n for n in self.ctx.notifications if n.at_time > self.ctx.game_time
        ]
        for n in due:
            e = self.find_entity(n.entity_id)
            if e is not None:
                self.run_entity_event(e, n.event, n.value)

        # proximity alerts (region.rs:1049-1075)
        for eid, radius in list(self.ctx.proximity_tracking.items()):
            e = self.find_entity(eid)
            if e is None:
                continue
            me = e.get_pos_xz()
            for other in self.ctx.entities:
                if other.id == eid:
                    continue
                if float(np.linalg.norm(other.get_pos_xz() - me)) <= radius:
                    self.run_entity_event(e, "proximity", float(other.id))

        # stream captured per-cell debug values to the editor
        # (region.rs:1070-1075)
        if self.ctx.debug_mode:
            self.outbox.put(
                RegionMessage(
                    RegionMessageKind.DebugData,
                    self.ctx.region_id,
                    data=self.ctx.debug.copy(),
                )
            )

    def set_debug_mode(self, on: bool) -> None:
        """region.rs:372-377 — toggling clears previous captures."""
        self.ctx.debug_mode = bool(on)
        self.ctx.debug.clear()

    def redraw_tick(self) -> None:
        """Drain inbox, advance actions, apply movement, send deltas
        (region.rs:1082-1700)."""
        if not self.running:
            return
        while True:
            try:
                msg = self.inbox.get_nowait()
            except queue.Empty:
                break
            self._handle_message(msg)

        if self.paused:
            return

        dt = self.REDRAW_DELTA
        for entity in self.ctx.entities:
            self._advance_action(entity, dt)

        # dirty deltas (region.rs:1680-1700)
        updates = []
        for entity in self.ctx.entities:
            if entity.is_dirty():
                updates.append(entity.get_update().pack())
                entity.clear_dirty()
        if updates:
            self.outbox.put(
                RegionMessage.entities_update(self.ctx.region_id, updates)
            )
        item_updates = []
        for item in self.ctx.items:
            if item.is_dirty():
                item_updates.append(item.get_update().pack())
                item.clear_dirty()
        if item_updates:
            self.outbox.put(
                RegionMessage.items_update(self.ctx.region_id, item_updates)
            )
        for m in self.out_messages:
            self.outbox.put(m)
        self.out_messages = []

    def _handle_message(self, msg: RegionMessage) -> None:
        k = msg.kind
        if k == RegionMessageKind.Event:
            e = self.find_entity(msg.entity_id)
            if e is not None:
                name, value = msg.data
                self.run_entity_event(e, name, value)
        elif k == RegionMessageKind.UserEvent:
            e = self.find_entity(msg.entity_id)
            if e is not None:
                name, value = msg.data
                self.run_user_event(e, name, value)
        elif k == RegionMessageKind.UserAction:
            e = self.find_entity(msg.entity_id)
            if e is not None:
                action = msg.data
                if (
                    isinstance(action, EntityAction)
                    and action.kind == EntityActionKind.Choice
                    and action.choice is not None
                ):
                    # choices are consumed immediately, not queued as
                    # movement state (region.rs:1285-1352)
                    self.handle_choice_action(action.choice)
                else:
                    e.action = action
        elif k == RegionMessageKind.CreateEntity:
            entity = msg.data
            if isinstance(entity, Entity):
                self.spawn_entity(entity)
            else:
                self.create_entity_instance(str(entity))
        elif k == RegionMessageKind.TransferEntity:
            entity, dest, pos = msg.data
            self.ctx.entities = [e for e in self.ctx.entities if e.id != entity.id]
            self.outbox.put(
                RegionMessage.transfer_entity(self.ctx.region_id, entity, dest, pos)
            )
        elif k == RegionMessageKind.Time:
            self.ctx.game_time = float(msg.data)
        elif k == RegionMessageKind.Pause:
            self.paused = True
        elif k == RegionMessageKind.Continue:
            self.paused = False
        elif k == RegionMessageKind.Quit:
            self.running = False

    def handle_choice_action(self, choice: Choice) -> None:
        """Consume a user-selected multiple-choice entry (region.rs:1285-1352).

        item_to_sell: price from the item's `worth`; the buyer must afford it
        (wallet vs the region currencies), then the item moves seller->buyer
        and the price moves buyer->seller, with a {you_bought}/{cant_afford}
        message to the buyer. cancel: fires the seller's `goodbye` event."""
        from .currency import wallet_can_afford

        if choice.kind == "item_to_sell":
            seller = self.find_entity(choice.seller_id)
            buyer = self.find_entity(choice.buyer_id)
            price = 0
            if seller is not None:
                item = seller.get_item(choice.item_id)
                if item is not None:
                    price = item.attributes.get_int_default("worth", 0)
            can_afford = buyer is not None and wallet_can_afford(
                buyer.wallet, price, self.ctx.currencies
            )
            if can_afford and seller is not None:
                slot = seller.get_item_slot(choice.item_id)
                item = seller.remove_item(slot) if slot is not None else None
                if item is not None:
                    seller.add_base_currency(price, self.ctx.currencies)
                    buyer.add_item(item)
                    buyer.spend_currency(price, self.ctx.currencies)
                    self.out_messages.append(
                        RegionMessage.message(
                            self.ctx.region_id,
                            0,
                            buyer.id,
                            "{you_bought} "
                            f"{{I:{item.id}.name, article=indef, case=lower}}",
                            "system",
                        )
                    )
            elif buyer is not None and not can_afford:
                # a missing seller/item is silent (region.rs:1309-1332 only
                # messages on a genuine failed affordability check)
                self.out_messages.append(
                    RegionMessage.message(
                        self.ctx.region_id, 0, buyer.id,
                        "{cant_afford}", "warning",
                    )
                )
        elif choice.kind == "cancel":
            e = self.find_entity(choice.from_id)
            if e is not None:
                self.run_entity_event(e, "goodbye", float(choice.to_id))

    # ---- EntityAction state machines (region.rs:1588-1704) ----

    def _advance_action(self, entity: Entity, dt: float) -> None:
        action = entity.action
        if action is None or action.kind == EntityActionKind.Off:
            return
        k = action.kind
        speed = action.speed if action.speed else 1.0
        step = 2.0 * speed * dt

        if k in (
            EntityActionKind.Forward,
            EntityActionKind.Backward,
            EntityActionKind.Left,
            EntityActionKind.Right,
        ):
            target_xz = {
                EntityActionKind.Forward: entity.move_forward,
                EntityActionKind.Backward: entity.move_backward,
                EntityActionKind.Left: entity.move_left,
                EntityActionKind.Right: entity.move_right,
            }[k](step)
            self._apply_move(entity, target_xz)
        elif k == EntityActionKind.Goto:
            tx, ty = action.target
            delta = np.array([tx, ty], np.float32) - entity.get_pos_xz()
            dist = float(np.linalg.norm(delta))
            if dist < 0.05:
                entity.action = EntityAction(EntityActionKind.Off)
                self.run_entity_event(entity, "arrived", None)
                return
            entity.face_at((tx, ty))
            move = delta / dist * min(step, dist)
            self._apply_move(entity, entity.get_pos_xz() + move)
        elif k == EntityActionKind.CloseIn:
            target = self.find_entity(int(action.target[0]))
            if target is None:
                entity.action = EntityAction(EntityActionKind.Off)
                return
            delta = target.get_pos_xz() - entity.get_pos_xz()
            dist = float(np.linalg.norm(delta))
            if dist <= action.distance:
                self.run_entity_event(entity, "closed_in", float(target.id))
                return
            entity.face_at(target.get_pos_xz())
            move = delta / max(dist, 1e-6) * min(step, dist - action.distance)
            self._apply_move(entity, entity.get_pos_xz() + move)
        elif k in (EntityActionKind.RandomWalk, EntityActionKind.RandomWalkInSector):
            action.state_time -= dt
            if action.target is None or action.state_time <= 0.0:
                angle = random.uniform(0, math.tau)
                d = random.uniform(0.3, max(action.distance, 0.3))
                pos = entity.get_pos_xz()
                target = pos + np.array(
                    [math.cos(angle) * d, math.sin(angle) * d], np.float32
                )
                if k == EntityActionKind.RandomWalkInSector and self.ctx.map is not None:
                    sector = self.ctx.map.sector_at(*pos)
                    if sector is not None and not sector.is_inside(self.ctx.map, target):
                        target = pos
                action.target = (float(target[0]), float(target[1]))
                action.state_time = random.uniform(0.5, max(action.max_sleep, 0.5))
            tx, ty = action.target
            delta = np.array([tx, ty], np.float32) - entity.get_pos_xz()
            dist = float(np.linalg.norm(delta))
            if dist > 0.05:
                entity.face_at((tx, ty))
                move = delta / dist * min(step, dist)
                self._apply_move(entity, entity.get_pos_xz() + move)
        elif k == EntityActionKind.SleepAndSwitch:
            if self.ctx.game_time >= action.until:
                entity.action = action.next_action or EntityAction(EntityActionKind.Off)

    def _apply_move(self, entity: Entity, target_xz) -> None:
        """collision_world.move_distance (region.rs:2032-2048)."""
        start = entity.position.copy()
        move = np.array(
            [target_xz[0] - start[0], 0.0, target_xz[1] - start[2]], np.float32
        )
        new_pos, blocked = self.ctx.collision_world.move_distance(start, move, 0.3)
        if not np.allclose(new_pos, start):
            entity.set_position(new_pos)
        if blocked:
            self.run_entity_event(entity, "bumped_into_wall", None)


def _to_vmvalue(value) -> VMValue:
    if isinstance(value, VMValue):
        return value
    if isinstance(value, str):
        return VMValue.from_string(value)
    if value is None:
        return VMValue.zero()
    try:
        return VMValue.broadcast(float(value))
    except (TypeError, ValueError):
        return VMValue.from_string(str(value))
