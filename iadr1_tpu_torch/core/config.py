"""Config plumbing (the port's own copy of iadr1_tpu/core/config.py): a
yaml or json file plus ``key.subkey=value`` overrides -> nested
dataclasses, with type coercion; unknown keys raise."""

from __future__ import annotations

import dataclasses
import json
import typing
from pathlib import Path
from typing import Any, Type, TypeVar

T = TypeVar("T")


def _coerce(value: Any, typ: Any) -> Any:
    origin = typing.get_origin(typ)
    if origin is typing.Union:
        args = [a for a in typing.get_args(typ) if a is not type(None)]
        if value is None:
            return None
        return _coerce(value, args[0])
    if dataclasses.is_dataclass(typ) and isinstance(value, dict):
        return dataclass_from_dict(typ, value)
    if origin in (list, tuple):
        (elem_t,) = typing.get_args(typ)[:1] or (Any,)
        seq = [_coerce(v, elem_t) for v in value]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        return dict(value)
    if typ is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    if typ in (int, float, str) and value is not None:
        return typ(value)
    return value


def dataclass_from_dict(cls: Type[T], data: dict) -> T:
    """Hydrate a (possibly nested) dataclass from a plain dict, with type
    coercion; unknown keys raise to catch config typos early."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    hints = typing.get_type_hints(cls)
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(
            f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    return cls(**{k: _coerce(v, hints[k]) for k, v in data.items()})


def _parse_scalar(text: str) -> Any:
    try:
        return json.loads(text)
    except ValueError:              # json.JSONDecodeError is one
        return text


def apply_overrides(data: dict, overrides: list[str]) -> dict:
    """Apply ``a.b.c=value`` overrides onto a nested dict (in place)."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of the form key=value")
        key, _, raw = item.partition("=")
        node = data
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _parse_scalar(raw)
    return data


def load_config(cls: Type[T], path: str | Path | None = None,
                overrides: list[str] | None = None) -> T:
    """Load a dataclass config from a yaml or json file plus overrides."""
    data: dict = {}
    if path is not None:
        path = Path(path)
        text = path.read_text()
        if path.suffix in (".yaml", ".yml"):
            import yaml

            data = yaml.safe_load(text) or {}
        else:
            data = json.loads(text)
    if overrides:
        apply_overrides(data, overrides)
    return dataclass_from_dict(cls, data)
