"""Server — region orchestrator (reference src/server/mod.rs).

Keeps a registry of region instances behind message queues (the reference's
crossbeam REGIONPIPE, mod.rs:22-28), fans out system/redraw ticks, drains
region outboxes and mirrors entity/item state via the packed delta protocol,
routes local player input, and handles cross-region TransferEntity.
"""

from __future__ import annotations

import enum
import queue
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .entity import Entity, EntityUpdate
from .item import Item, ItemUpdate
from .message import (
    EntityAction,
    RegionMessage,
    RegionMessageKind,
)
from .region import RegionInstance


class ServerState(enum.IntEnum):
    """reference mod.rs:34"""

    Off = 0
    Running = 1
    Paused = 2


@dataclass
class Server:
    state: ServerState = ServerState.Off
    instances: List[RegionInstance] = field(default_factory=list)
    region_by_name: Dict[str, int] = field(default_factory=dict)

    # mirrored state per region (mod.rs:40-67)
    entities: Dict[int, List[Entity]] = field(default_factory=dict)
    items: Dict[int, List[Item]] = field(default_factory=dict)
    messages: List[Tuple[int, int, str, str]] = field(default_factory=list)
    choices: List[object] = field(default_factory=list)
    times: Dict[int, float] = field(default_factory=dict)

    # local players: entity_id -> region_id (LOCAL_PLAYERS, mod.rs:26-28)
    local_players: Dict[int, int] = field(default_factory=dict)

    log: str = ""
    log_changed: bool = False
    #: region_id -> merged DebugModule (reference src/server/mod.rs:44-45)
    debug_modules: Dict[int, object] = field(default_factory=dict)
    debug_changed: bool = False
    _next_region_id: int = 0

    # ---- region lifecycle (mod.rs:119-142, 534-588) ----

    def create_region_instance(
        self, name: str, map_, entities=None, items=None, config: str = ""
    ) -> int:
        region = RegionInstance(self._next_region_id, name)
        self._next_region_id += 1
        region.init(map_, entities or {}, items or {}, config)
        self.instances.append(region)
        self.region_by_name[name] = region.ctx.region_id
        self.entities[region.ctx.region_id] = []
        self.items[region.ctx.region_id] = []
        return region.ctx.region_id

    def get_region(self, region_id: int) -> Optional[RegionInstance]:
        for inst in self.instances:
            if inst.ctx.region_id == region_id:
                return inst
        return None

    def start(self) -> None:
        self.state = ServerState.Running

    def pause(self) -> None:
        self.state = ServerState.Paused
        for inst in self.instances:
            inst.inbox.put(RegionMessage(RegionMessageKind.Pause))

    def cont(self) -> None:
        self.state = ServerState.Running
        for inst in self.instances:
            inst.inbox.put(RegionMessage(RegionMessageKind.Continue))

    def stop(self) -> None:
        self.state = ServerState.Off
        for inst in self.instances:
            inst.inbox.put(RegionMessage(RegionMessageKind.Quit))

    # ---- ticks (mod.rs:144-156) ----

    def system_tick(self) -> None:
        for inst in self.instances:
            inst.system_tick()

    def redraw_tick(self) -> None:
        for inst in self.instances:
            inst.redraw_tick()

    # ---- update pump (mod.rs:266-425) ----

    def update(self) -> None:
        for inst in self.instances:
            rid = inst.ctx.region_id
            while True:
                try:
                    msg = inst.outbox.get_nowait()
                except queue.Empty:
                    break
                self._process_region_message(rid, msg)

    def _process_region_message(self, rid: int, msg: RegionMessage) -> None:
        k = msg.kind
        if k == RegionMessageKind.EntitiesUpdate:
            self._process_entity_updates(rid, msg.data)
        elif k == RegionMessageKind.ItemsUpdate:
            self._process_item_updates(rid, msg.data)
        elif k == RegionMessageKind.LogMessage:
            self.log += str(msg.data) + "\n"
            self.log_changed = True
        elif k == RegionMessageKind.Time:
            self.times[rid] = float(msg.data)
        elif k == RegionMessageKind.Message:
            self.messages.append(msg.data)
        elif k == RegionMessageKind.MultipleChoice:
            self.choices.append(msg.data)
        elif k == RegionMessageKind.TransferEntity:
            self._transfer_entity(rid, msg)
        elif k == RegionMessageKind.DebugData:
            # merge per-region debug captures (mod.rs:44-45 debug registry)
            existing = self.debug_modules.get(rid)
            if existing is None:
                self.debug_modules[rid] = msg.data
            else:
                existing.merge(msg.data)
            self.debug_changed = True

    def _transfer_entity(self, source_rid: int, msg: RegionMessage) -> None:
        """Cross-region handoff incl. player re-homing (mod.rs:340-415)."""
        entity, dest_name, dest_pos = msg.data
        dest_id = self.region_by_name.get(dest_name)
        dest = self.get_region(dest_id) if dest_id is not None else None
        if dest is None:
            # fallback: return to the source region (mod.rs:365-369)
            dest = self.get_region(source_rid)
            if dest is None:
                return
        if dest_pos is not None:
            entity.set_position(dest_pos)
        dest.spawn_entity(entity)
        if entity.id in self.local_players or entity.is_player():
            self.local_players[entity.id] = dest.ctx.region_id

    def _process_entity_updates(self, rid: int, packed_updates) -> None:
        """mod.rs:426+ — apply bincode deltas to the mirror."""
        mirror = self.entities.setdefault(rid, [])
        inst = self.get_region(rid)
        for blob in packed_updates:
            update = EntityUpdate.unpack(blob)
            target = next((e for e in mirror if e.id == update.id), None)
            if target is None:
                target = Entity()
                target.id = update.id
                # seed from the live entity so mirrors carry full state
                if inst is not None:
                    live = inst.find_entity(update.id)
                    if live is not None:
                        target.position = live.position.copy()
                        target.orientation = live.orientation.copy()
                        for key, v in live.attributes.items():
                            target.attributes._values[key] = v
                mirror.append(target)
            target.apply_update(update)

    def _process_item_updates(self, rid: int, packed_updates) -> None:
        mirror = self.items.setdefault(rid, [])
        for blob in packed_updates:
            update = ItemUpdate.unpack(blob)
            target = next((i for i in mirror if i.id == update.id), None)
            if target is None:
                target = Item()
                target.id = update.id
                mirror.append(target)
            target.apply_update(update)

    # ---- player routing (mod.rs:494-532) ----

    def register_player(self, region_name: str, class_name: str, position=None) -> Optional[int]:
        rid = self.region_by_name.get(region_name)
        inst = self.get_region(rid) if rid is not None else None
        if inst is None:
            return None
        entity = inst.create_entity_instance(class_name, position)
        self.local_players[entity.id] = rid
        return entity.id

    def local_player_event(self, entity_id: int, event: str, value=None) -> None:
        rid = self.local_players.get(entity_id)
        inst = self.get_region(rid) if rid is not None else None
        if inst is not None:
            inst.inbox.put(
                RegionMessage.user_event(rid, entity_id, event, value)
            )

    def local_player_action(self, entity_id: int, action: EntityAction) -> None:
        rid = self.local_players.get(entity_id)
        inst = self.get_region(rid) if rid is not None else None
        if inst is not None:
            inst.inbox.put(RegionMessage.user_action(rid, entity_id, action))

    # ---- mirror application (mod.rs:202 apply_entities_items) ----

    def apply_entities_items(self, map_) -> None:
        rid = self.region_by_name.get(map_.name)
        if rid is None and self.instances:
            rid = self.instances[0].ctx.region_id
        map_.entities = list(self.entities.get(rid, []))
        map_.items = list(self.items.get(rid, []))

    def get_log(self) -> str:
        self.log_changed = False
        return self.log

    # ---- reference accessor surface (mod.rs:103-264) ----

    def clear_log(self) -> None:
        """mod.rs:103-105."""
        self.log = ""

    def set_state(self, state: ServerState) -> None:
        """mod.rs:114-116."""
        self.state = state

    def clear(self) -> None:
        """Drop all regions and mirrored state (fresh server)."""
        self.stop()
        self.instances = []
        self.region_by_name = {}
        self.entities = {}
        self.items = {}
        self.messages = []
        self.choices = []
        self.times = {}
        self.local_players = {}
        self.debug_modules = {}

    def get_entities_items(self, region) -> Tuple[List[Entity], List[Item]]:
        """Mirrored entities/items for a region (mod.rs:180-200); accepts a
        region id or name."""
        rid = self.region_by_name.get(region, region)
        return list(self.entities.get(rid, [])), list(self.items.get(rid, []))

    def get_messages(self, region=None) -> list:
        """Drain queued messages — all, or only the given region's
        (mod.rs:215-223 drains per region)."""
        if region is None:
            out, self.messages = self.messages, []
            return out
        rid = self.region_by_name.get(region, region)
        out = [m for m in self.messages if m[0] == rid or m[1] == rid]
        self.messages = [m for m in self.messages if m not in out]
        return out

    def get_choices(self) -> list:
        """Drain queued multiple-choice requests (mod.rs:226-234)."""
        out, self.choices = self.choices, []
        return out

    def get_time(self, region) -> Optional[float]:
        """Game time (minutes of day) for a region (mod.rs:237-244)."""
        rid = self.region_by_name.get(region, region)
        return self.times.get(rid)

    def set_time(self, region, minutes: float) -> None:
        """Push a new game time to a region (mod.rs:247-258)."""
        rid = self.region_by_name.get(region, region)
        inst = self.get_region(rid)
        if inst is not None:
            inst.inbox.put(RegionMessage.time(rid, float(minutes)))
            self.times[rid] = float(minutes)

    def process_client_commands(self, commands) -> None:
        """Route client create-entity commands into regions
        (mod.rs:158-177). Accepts Command(CreateEntity, (region, entity))
        or the client.setup tuples ('create_player', region, class)."""
        from ..client.command import Command, CommandKind

        for cmd in commands:
            if isinstance(cmd, Command):
                if cmd.kind != CommandKind.CreateEntity:
                    continue
                region, entity = cmd.data
            elif isinstance(cmd, tuple) and cmd and cmd[0] == "create_player":
                _, region, entity = cmd
            else:
                continue
            rid = self.region_by_name.get(region, region)
            inst = self.get_region(rid)
            if inst is not None:
                inst.inbox.put(
                    RegionMessage(
                        RegionMessageKind.CreateEntity, rid, data=entity
                    )
                )
