"""Dynamic property values (reference src/value.rs, src/value_toml.rs).

`Value` is a tagged dynamic value; `ValueContainer` an ordered string->Value
map with typed getters/defaults — attached to every map element, entity and
light in the reference.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


class ValueKind(enum.IntEnum):
    NoValue = 0
    Bool = 1
    Int = 2
    Int64 = 3
    UInt = 4
    Float = 5
    Str = 6
    Vec2 = 7
    Vec3 = 8
    Vec4 = 9
    Color = 10
    Source = 11  # PixelSource
    Light = 12
    TileOverrides = 13
    Id = 14
    StrArray = 15
    IntArray = 16
    FloatArray = 17


@dataclass
class Value:
    kind: ValueKind
    data: Any = None

    # constructors
    @staticmethod
    def bool_(b):
        return Value(ValueKind.Bool, bool(b))

    @staticmethod
    def int_(i):
        return Value(ValueKind.Int, int(i))

    @staticmethod
    def float_(f):
        return Value(ValueKind.Float, float(f))

    @staticmethod
    def str_(s):
        return Value(ValueKind.Str, str(s))

    @staticmethod
    def source(s):
        return Value(ValueKind.Source, s)

    @staticmethod
    def light(l):
        return Value(ValueKind.Light, l)

    @staticmethod
    def from_python(v) -> "Value":
        if isinstance(v, Value):
            return v
        # late imports to avoid cycles
        from ..models.batch import PixelSource as _PixelSource
        from ..models.light import CompiledLight as _CompiledLight, Light as _Light

        if isinstance(v, _PixelSource):
            return Value(ValueKind.Source, v)
        if isinstance(v, (_Light, _CompiledLight)):
            return Value(ValueKind.Light, v)
        if isinstance(v, bool):
            return Value.bool_(v)
        if isinstance(v, int):
            return Value.int_(v)
        if isinstance(v, float):
            return Value.float_(v)
        if isinstance(v, str):
            return Value.str_(v)
        if isinstance(v, (tuple, list)):
            if v and all(isinstance(x, str) for x in v):
                return Value(ValueKind.StrArray, tuple(v))
            n = len(v)
            kind = {2: ValueKind.Vec2, 3: ValueKind.Vec3, 4: ValueKind.Vec4}.get(
                n, ValueKind.FloatArray
            )
            return Value(kind, tuple(float(x) for x in v))
        return Value(ValueKind.NoValue, v)

    def to_python(self):
        return self.data


class ValueContainer:
    """Ordered property bag with typed getters (reference src/value.rs:196+)."""

    def __init__(self, initial: Optional[Dict[str, Any]] = None):
        self._values: Dict[str, Value] = {}
        if initial:
            for k, v in initial.items():
                self.set(k, v)

    def set(self, key: str, value) -> None:
        self._values[key] = Value.from_python(value)

    def get(self, key: str) -> Optional[Value]:
        return self._values.get(key)

    def contains(self, key: str) -> bool:
        return key in self._values

    def remove(self, key: str) -> None:
        self._values.pop(key, None)

    def keys(self):
        return self._values.keys()

    def items(self):
        return self._values.items()

    def __len__(self):
        return len(self._values)

    # typed getters with defaults (get_float_default etc.)

    def get_float_default(self, key: str, default: float) -> float:
        v = self._values.get(key)
        if v is None:
            return default
        if v.kind in (ValueKind.Float, ValueKind.Int, ValueKind.Int64, ValueKind.UInt):
            return float(v.data)
        if v.kind == ValueKind.Bool:
            return 1.0 if v.data else 0.0
        return default

    def get_int_default(self, key: str, default: int) -> int:
        v = self._values.get(key)
        if v is None:
            return default
        if v.kind in (ValueKind.Int, ValueKind.Int64, ValueKind.UInt):
            return int(v.data)
        if v.kind == ValueKind.Float:
            return int(v.data)
        if v.kind == ValueKind.Bool:
            return 1 if v.data else 0
        return default

    def get_bool_default(self, key: str, default: bool) -> bool:
        v = self._values.get(key)
        if v is None:
            return default
        if v.kind == ValueKind.Bool:
            return bool(v.data)
        if v.kind in (ValueKind.Int, ValueKind.Float):
            return bool(v.data)
        return default

    def get_str_default(self, key: str, default: str) -> str:
        v = self._values.get(key)
        if v is not None and v.kind == ValueKind.Str:
            return str(v.data)
        return default

    def get_source(self, key: str):
        v = self._values.get(key)
        if v is not None and v.kind == ValueKind.Source:
            return v.data
        return None

    def get_vec(self, key: str, default=None):
        v = self._values.get(key)
        if v is not None and v.kind in (
            ValueKind.Vec2,
            ValueKind.Vec3,
            ValueKind.Vec4,
            ValueKind.FloatArray,
        ):
            return v.data
        return default

    def _typed(self, key: str, kinds):
        v = self._values.get(key)
        if v is not None and v.kind in kinds:
            return v.data
        return None

    # plain typed getters (value.rs:196-430; the *_default family is above)

    def get_bool(self, key: str):
        return self._typed(key, (ValueKind.Bool,))

    def get_int(self, key: str):
        return self._typed(
            key, (ValueKind.Int, ValueKind.Int64, ValueKind.UInt)
        )

    def get_float(self, key: str):
        return self._typed(key, (ValueKind.Float,))

    def get_str(self, key: str):
        return self._typed(key, (ValueKind.Str,))

    def get_vec2(self, key: str):
        return self._typed(key, (ValueKind.Vec2,))

    def get_vec3(self, key: str):
        return self._typed(key, (ValueKind.Vec3,))

    def get_vec4(self, key: str):
        return self._typed(key, (ValueKind.Vec4,))

    def get_vec3_default(self, key: str, default):
        v = self.get_vec3(key)
        return v if v is not None else default

    def get_color_default(self, key: str, default):
        v = self._typed(key, (ValueKind.Color,))
        return v if v is not None else default

    def get_id(self, key: str):
        return self._typed(key, (ValueKind.Id,))

    def get_default_source(self):
        """value.rs:380-388: the 'source' property when it's a PixelSource."""
        return self._typed("source", (ValueKind.Source,))

    def toggle(self, key: str) -> None:
        """Flip a Bool property in place (value.rs:225-229)."""
        v = self._values.get(key)
        if v is not None and v.kind == ValueKind.Bool:
            v.data = not v.data

    def keys_sorted(self):
        """Sorted key list (the container preserves insertion order like
        the reference's IndexMap; this is the sorted view)."""
        return sorted(self._values.keys())

    def values(self):
        return list(self._values.values())

    def copy(self) -> "ValueContainer":
        out = ValueContainer()
        out._values = dict(self._values)
        return out

    @staticmethod
    def from_toml(text: str, group: Optional[str] = None) -> "ValueContainer":
        """TOML -> container (reference src/value_toml.rs:12-86)."""
        import tomllib

        data = tomllib.loads(text)
        if group is not None:
            data = data.get(group, {})
        out = ValueContainer()
        for k, v in data.items():
            if isinstance(v, dict):
                continue
            out.set(k, v)
        return out

