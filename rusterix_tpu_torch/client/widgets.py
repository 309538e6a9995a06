"""Game UI widgets (reference src/client/widget/).

GameWidget pumps incremental chunk builds into the scene and draws the 3D
viewport (widget/game.rs); ScreenWidget renders 2D "screen maps" through the
rasterizer (widget/screen.rs:81); TextWidget/MessagesWidget draw text via
Draw2D.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..utils.rect import Rect
from .draw2d import Draw2D


@dataclass
class Widget:
    rect: Rect = field(default_factory=Rect)
    visible: bool = True

    def draw(self, buf: np.ndarray, ctx) -> None:
        pass


@dataclass
class TextWidget(Widget):
    """widget/text.rs — a text label."""

    text: str = ""
    color: Tuple[int, int, int, int] = (255, 255, 255, 255)
    size: int = 12
    centered: bool = True
    #: game-supplied font path (resolved through Assets.fonts by
    #: init_screen), None = system default — draw2d.rs:617+ `&Font` parity
    font: Optional[str] = None

    def draw(self, buf: np.ndarray, ctx=None) -> None:
        if not self.visible or not self.text:
            return
        d = Draw2D()
        if self.centered:
            d.text_centered(
                buf,
                (int(self.rect.x), int(self.rect.y), int(self.rect.width), int(self.rect.height)),
                self.text,
                self.color,
                self.size,
                font=self.font,
            )
        else:
            d.text(
                buf, int(self.rect.x), int(self.rect.y), self.text,
                self.color, self.size, font=self.font,
            )


@dataclass
class DecoWidget(Widget):
    """widget/deco.rs — a colored/textured rectangle decoration."""

    color: Tuple[int, int, int, int] = (40, 40, 48, 255)
    texture: Optional[np.ndarray] = None  # (h, w, 4) u8
    outline: Optional[Tuple[int, int, int, int]] = None

    def draw(self, buf: np.ndarray, ctx=None) -> None:
        if not self.visible:
            return
        d = Draw2D()
        x, y = int(self.rect.x), int(self.rect.y)
        w, h = int(self.rect.width), int(self.rect.height)
        if self.texture is not None:
            d.blit_scaled(buf, self.texture, x, y, w, h)
        else:
            d.rect(buf, x, y, w, h, self.color)
        if self.outline is not None:
            d.rect_outline(buf, x, y, w, h, self.outline)


@dataclass
class MessageEntry:
    """One log line; interactive when it carries a multiple-choice entry
    (widget/messages.rs message tuple: uuid, text, rect, choice, color)."""

    text: str = ""
    choice: object = None  # server.message.Choice or None
    color: Tuple[int, int, int, int] = (255, 255, 255, 255)
    rect: Rect = field(default_factory=Rect)
    uid: int = 0


@dataclass
class MessagesWidget(Widget):
    """widget/messages.rs — scrolling message log + multiple-choice menu."""

    entries: List[MessageEntry] = field(default_factory=list)
    max_messages: int = 6
    max_entries: int = 100  # purge bound (messages.rs:198-203)
    color: Tuple[int, int, int, int] = (255, 255, 255, 255)
    choice_color: Tuple[int, int, int, int] = (255, 220, 120, 255)
    column_width: int = 20  # item-name padding (messages.rs:135)
    size: int = 11
    line_height: int = 14
    #: game-supplied font path (see TextWidget.font)
    font: Optional[str] = None

    #: uid of the multiple-choice entry under the pointer (messages.rs)
    clicked: int = 0
    _next_uid: int = 1

    @property
    def messages(self) -> List[str]:
        return [e.text for e in self.entries]

    def add(self, text: str, choice=None, color=None) -> None:
        self._next_uid += 1
        self.entries.append(
            MessageEntry(
                text=text,
                choice=choice,
                color=color or (self.choice_color if choice is not None else self.color),
                uid=self._next_uid,
            )
        )
        if len(self.entries) > self.max_entries:
            self.entries = self.entries[-self.max_entries:]

    def process_choices(self, choices, map_=None, resolve=None):
        """Turn pending MultipleChoice requests into rendered menu entries and
        a key->Choice map (widget/messages.rs:110-208): entry i answers to key
        '1'+i, '0' is the cancel entry. Item entries show the item's name and
        `worth` looked up from the mirrored map entities. Returns the
        choice_map or None when there were no choices."""
        from ..server.message import Choice

        resolve = resolve or (lambda s: s)
        choice_map = {}
        for mc in choices:
            cancel = Choice.cancel(mc.sender, mc.receiver)
            choice_map["0"] = cancel
            for index, choice in enumerate(mc.choices):
                choice_map[chr(ord("1") + index)] = choice
                item_name, item_price = "", 0
                if choice.kind == "item_to_sell" and map_ is not None:
                    for entity in getattr(map_, "entities", []):
                        if entity.id != choice.seller_id:
                            continue
                        for _, item in entity.iter_inventory():
                            if item.id == choice.item_id:
                                item_name = item.attributes.get_str_default("name", "")
                                item_price = item.attributes.get_int_default("worth", 0)
                                break
                        break
                padded = f"{item_name:<{self.column_width}}"
                self.add(f"{index + 1}) {padded} {item_price}G", choice=choice)
            self.add(resolve("0) {exit_menu}"), choice=cancel)
        return choice_map or None

    def touch_down(self, x: float, y: float):
        """Hit-test interactive entries; returns the selecting EntityAction
        (widget/messages.rs:315-325). Hidden widgets keep their last-drawn
        rects but must not claim taps."""
        from ..server.message import EntityAction, EntityActionKind

        if not self.visible:
            return None
        for e in self.entries:
            if e.choice is not None and e.rect.contains(x, y):
                self.clicked = e.uid
                return EntityAction(EntityActionKind.Choice, choice=e.choice)
        return None

    def touch_up(self) -> None:
        """Clear the clicked choice (widget/messages.rs:326-328)."""
        self.clicked = 0

    def draw(self, buf: np.ndarray, ctx=None) -> None:
        if not self.visible:
            return
        d = Draw2D()
        x, y = int(self.rect.x), int(self.rect.y)
        shown = self.entries[-self.max_messages:]
        # entries scrolled out of view are not clickable
        for e in self.entries[: len(self.entries) - len(shown)]:
            e.rect = Rect()
        for i, e in enumerate(shown):
            ey = y + i * self.line_height
            e.rect = Rect(x, ey, self.rect.width, self.line_height)
            d.text(buf, x, ey, e.text, e.color, self.size, font=self.font)


@dataclass
class ScreenWidget(Widget):
    """widget/screen.rs — renders a 2D 'screen map' through the rasterizer
    into the widget rect (the reference path that still uses the software
    Rasterizer directly, screen.rs:81)."""

    screen_map: object = None  # a Map whose sectors carry UI shapes
    grid_size: float = 16.0

    def draw(self, buf: np.ndarray, ctx) -> None:
        if not self.visible or self.screen_map is None:
            return
        from ..builders import D2Builder
        from ..models.scene import Scene
        from ..ops.matrices import mat3_translation_scale
        from ..ops.raster import Rasterizer

        assets = ctx.get("assets") if isinstance(ctx, dict) else None
        w, h = int(self.rect.width), int(self.rect.height)
        if w <= 0 or h <= 0:
            return
        scene = Scene.empty()
        D2Builder().build(self.screen_map, assets, scene)
        proj2d = mat3_translation_scale(w / 2.0, h / 2.0, self.grid_size)
        rast = Rasterizer.setup(
            proj2d, np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32),
            device=ctx.get("device") if isinstance(ctx, dict) else None,
        )
        frame = rast.rasterize(scene, w, h, 64, assets)
        Draw2D().blend_blit(buf, frame, int(self.rect.x), int(self.rect.y))


@dataclass
class GameWidget(Widget):
    """widget/game.rs — the 3D viewport: pumps the SceneManager's incremental
    chunk results into the scene, then renders through the client camera."""

    scene_manager: object = None
    client: object = None
    ambient: Optional[tuple] = None

    def pump_chunks(self, scene) -> int:
        """Drain pending chunk builds into scene.chunks
        (widget/game.rs:146-180). Returns chunks applied."""
        if self.scene_manager is None:
            return 0
        applied = 0
        while True:
            result = self.scene_manager.tick()
            if result is None:
                break
            if result.kind == "chunk" and result.coord is not None:
                scene.chunks[result.coord] = result.chunk
                scene.touch()
                applied += 1
            if result.remaining == 0:
                break
        return applied

    def draw(self, buf: np.ndarray, ctx) -> None:
        if not self.visible or self.client is None:
            return
        assets = ctx.get("assets") if isinstance(ctx, dict) else None
        self.pump_chunks(self.client.scene)
        w, h = int(self.rect.width), int(self.rect.height)
        frame = self.client.draw_d3(w, h, assets, self.ambient)
        Draw2D().blit(buf, frame, int(self.rect.x), int(self.rect.y))
