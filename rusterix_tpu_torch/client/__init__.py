from .action import ClientAction
from .billboard import (
    BillboardAnimState,
    animate_billboards,
    find_item_by_profile_attrs,
)
from .client import Client, ClientConfig
from .command import Command, CommandKind
from .screens import (
    ButtonWidget,
    align_screen_to_grid,
    draw_screen,
    init_screen,
    touch_screen,
)
from .daylight import Daylight
from .draw2d import Draw2D
from .parser import MsgParser, Tok
from .widgets import (
    DecoWidget,
    GameWidget,
    MessagesWidget,
    ScreenWidget,
    TextWidget,
    Widget,
)

__all__ = [
    "ClientAction",
    "BillboardAnimState",
    "animate_billboards",
    "find_item_by_profile_attrs",
    "Client",
    "ClientConfig",
    "ButtonWidget",
    "align_screen_to_grid",
    "draw_screen",
    "init_screen",
    "touch_screen",
    "Command",
    "CommandKind",
    "Daylight",
    "Draw2D",
    "MsgParser",
    "Tok",
    "DecoWidget",
    "GameWidget",
    "MessagesWidget",
    "ScreenWidget",
    "TextWidget",
    "Widget",
]
