"""Screen-map UI: sectors of a "screen" map become widgets.

Behavioral port of the reference's screen flow (src/client/mod.rs:795-906
draw composition, :1498-1760 init_screen, :1300-1360 button dispatch,
src/utils.rs align_screen_to_grid): each screen sector carries a TOML `data`
property whose `[ui]` table declares the widget role (game / button / text /
deco / messages) plus button semantics (action, intent, show/hide,
deactivate, inventory_index).
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.rect import Rect
from .widgets import (
    DecoWidget,
    GameWidget,
    MessagesWidget,
    ScreenWidget,
    TextWidget,
)


def align_screen_to_grid(width: float, height: float, grid_size: float) -> Tuple[float, float]:
    """Top-left of the centered screen grid, in grid units (utils.rs:2-20)."""
    return (-width / 2.0) / grid_size, (-height / 2.0) / grid_size


@dataclass
class ButtonWidget:
    """reference client Widget (button role, mod.rs:1683-1710)."""

    name: str = ""
    id: int = 0
    rect: Rect = field(default_factory=Rect)
    action: str = ""
    intent: Optional[str] = None
    show: Optional[List[str]] = None
    hide: Optional[List[str]] = None
    deactivate: List[str] = field(default_factory=list)
    inventory_index: Optional[int] = None


def _parse_ui(sector) -> Optional[dict]:
    v = sector.properties.get("data")
    if v is None or not isinstance(v.data, str):
        return None
    try:
        table = tomllib.loads(v.data)
    except Exception:
        return None
    ui = table.get("ui")
    return ui if isinstance(ui, dict) else None


def init_screen(client, screen_name: str, assets) -> None:
    """Build widget registries from the screen map's sectors
    (client/mod.rs:1498-1760)."""
    client.game_widgets = {}
    client.button_widgets = {}
    client.text_widgets = {}
    client.deco_widgets = {}
    client.messages_widget = None
    client.screen_widget = None
    client.activated_widgets = []
    client.permanently_activated_widgets = []
    client.widgets_to_hide = []
    client.current_screen = screen_name

    screen = assets.screens.get(screen_name)
    if screen is None:
        return

    grid = client.config.grid_size
    vw, vh = client.viewport

    # propagate ui.layer into the sector property for sorted 2D drawing
    for sector in screen.sectors:
        ui = _parse_ui(sector)
        if ui and "layer" in ui:
            sector.properties.set("layer", int(ui["layer"]))

    client.screen_widget = ScreenWidget(
        rect=Rect(0, 0, vw, vh), screen_map=screen, grid_size=grid
    )

    start_x, start_y = align_screen_to_grid(vw, vh, grid)
    for sector in screen.sectors:
        ui = _parse_ui(sector)
        if ui is None:
            continue
        bb = sector.bounding_box(screen)
        x = (bb.x - start_x) * grid
        y = (bb.y - start_y) * grid
        w = bb.width * grid
        h = bb.height * grid
        rect = Rect(x, y, w, h)
        role = str(ui.get("role", "none"))

        if role == "game":
            gw = GameWidget(rect=rect, client=client)
            client.game_widgets[sector.id] = gw
        elif role == "button":
            btn = ButtonWidget(
                name=getattr(sector, "name", ""),
                id=sector.id,
                rect=rect,
                action=str(ui.get("action", "")),
                intent=ui.get("intent"),
                show=list(ui["show"]) if isinstance(ui.get("show"), list) else None,
                hide=list(ui["hide"]) if isinstance(ui.get("hide"), list) else None,
                deactivate=list(ui.get("deactivate", [])),
                inventory_index=(
                    int(ui["inventory_index"]) if "inventory_index" in ui else None
                ),
            )
            client.button_widgets[sector.id] = btn
            if bool(ui.get("active", False)):
                client.activated_widgets.append(sector.id)
                client.permanently_activated_widgets.append(sector.id)
                if btn.hide:
                    client.widgets_to_hide = list(btn.hide)
        elif role == "text":
            # `font = "name"` resolves through game-supplied Assets.fonts
            # (collect_from_directory .ttf/.otf); unknown names fall back to
            # the system font inside Draw2D
            client.text_widgets[sector.id] = TextWidget(
                rect=rect,
                text=str(ui.get("text", "")),
                size=int(ui.get("size", 12)),
                font=assets.fonts.get(str(ui.get("font", ""))),
            )
        elif role == "deco":
            client.deco_widgets[sector.id] = DecoWidget(rect=rect)
        elif role == "messages":
            client.messages_widget = MessagesWidget(
                rect=rect, font=assets.fonts.get(str(ui.get("font", "")))
            )


def touch_screen(client, x: float, y: float, map_=None):
    """Button dispatch (client/mod.rs:1300-1360). Returns
    ("intent", s) / ("action", s) / ("item_clicked", index) or None."""
    result = None
    for wid, btn in getattr(client, "button_widgets", {}).items():
        if not btn.rect.contains(x, y):
            continue
        if wid not in client.activated_widgets:
            client.activated_widgets.append(wid)

        if btn.intent is not None:
            client.intent = btn.intent
            result = ("intent", btn.intent)
        elif btn.action:
            result = ("action", btn.action)

        if btn.hide is not None:
            client.widgets_to_hide = list(btn.hide)
        if btn.show is not None:
            client.widgets_to_hide = [
                s for s in client.widgets_to_hide if s not in btn.show
            ]
        if btn.inventory_index is not None:
            result = ("item_clicked", btn.inventory_index)

        if btn.deactivate:
            for name in btn.deactivate:
                for oid, other in client.button_widgets.items():
                    if other.name == name:
                        client.activated_widgets = [
                            i for i in client.activated_widgets if i != oid
                        ]
                        client.permanently_activated_widgets = [
                            i
                            for i in client.permanently_activated_widgets
                            if i != oid
                        ]
            if wid not in client.permanently_activated_widgets:
                client.permanently_activated_widgets.append(wid)
    return result


def draw_screen(client, buf: np.ndarray, assets) -> None:
    """Compose game widgets + screen map + overlay widgets into `buf`
    (client/mod.rs:835-906)."""
    ctx = {"assets": assets, "device": client.device}
    hidden = set(getattr(client, "widgets_to_hide", []))

    for gw in getattr(client, "game_widgets", {}).values():
        gw.draw(buf, ctx)

    if getattr(client, "screen_widget", None) is not None:
        client.screen_widget.draw(buf, ctx)

    for wid, tw in getattr(client, "text_widgets", {}).items():
        if tw.visible and getattr(tw, "text", "") not in hidden:
            tw.draw(buf, ctx)
    for dw in getattr(client, "deco_widgets", {}).values():
        dw.draw(buf, ctx)
    if getattr(client, "messages_widget", None) is not None:
        client.messages_widget.draw(buf, ctx)

    # activated buttons get a highlight outline (stand-in for the
    # reference's activated textures; sources are optional there too)
    from .draw2d import Draw2D

    d = Draw2D()
    for wid in getattr(client, "activated_widgets", []):
        btn = client.button_widgets.get(wid)
        if btn is not None and btn.name not in hidden:
            d.rect_outline(
                buf,
                int(btn.rect.x),
                int(btn.rect.y),
                int(btn.rect.width),
                int(btn.rect.height),
                (255, 255, 255, 255),
            )
