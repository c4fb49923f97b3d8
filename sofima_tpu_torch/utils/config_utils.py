"""Dataclass-based configuration utilities.

Twin of sofima_tpu/utils/config_utils.py (numpy only; the port keeps its
own copy): deep dict overrides of nested (frozen) dataclasses, enums
converted from their values, JSON round-tripping, and a named
default-config registry of its own, separate from the reference's.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Callable, Type, TypeVar

T = TypeVar('T')


def _convert(value: Any, field_type: Any) -> Any:
  """Best-effort conversion of a plain value to the declared field type."""
  if dataclasses.is_dataclass(field_type) and isinstance(value, dict):
    return dataclass_from_dict(field_type, value)
  if (isinstance(field_type, type) and issubclass(field_type, enum.Enum)
      and not isinstance(value, enum.Enum)):
    return field_type(value)
  return value


def dataclass_from_dict(cls: Type[T], data: dict[str, Any]) -> T:
  """Builds a (possibly nested) dataclass from a plain dict."""
  kwargs = {}
  fields = {f.name: f for f in dataclasses.fields(cls)}
  for key, value in data.items():
    if key not in fields:
      raise KeyError(f'{cls.__name__} has no field {key!r}')
    kwargs[key] = _convert(value, fields[key].type_resolved
                           if hasattr(fields[key], 'type_resolved')
                           else _resolve_type(cls, fields[key]))
  return cls(**kwargs)


def _resolve_type(cls, field) -> Any:
  t = field.type
  if isinstance(t, str):
    import typing
    import sys
    mod = sys.modules.get(cls.__module__)
    try:
      # pylint: disable-next=eval-used
      t = eval(t, vars(mod) if mod else {}, dict(vars(typing)))
    except Exception:  # pragma: no cover - fall back to raw value
      return Any
  return t


def update_dataclass(obj: T, overrides: dict[str, Any]) -> T:
  """Returns a copy of `obj` with values deep-overridden from a dict.

  Nested dicts recurse into nested dataclass fields; all other values
  replace the field wholesale. Works with frozen dataclasses.
  """
  changes = {}
  fields = {f.name: f for f in dataclasses.fields(obj)}
  for key, value in overrides.items():
    if key not in fields:
      raise KeyError(f'{type(obj).__name__} has no field {key!r}')
    current = getattr(obj, key)
    if dataclasses.is_dataclass(current) and isinstance(value, dict):
      changes[key] = update_dataclass(current, value)
    else:
      ftype = _resolve_type(type(obj), fields[key])
      changes[key] = _convert(value, ftype)
  return dataclasses.replace(obj, **changes)


def dataclass_to_dict(obj: Any) -> Any:
  """Recursively converts a dataclass to JSON-serializable primitives."""
  if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
    return {f.name: dataclass_to_dict(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}
  if isinstance(obj, enum.Enum):
    return obj.value
  if isinstance(obj, (list, tuple)):
    return [dataclass_to_dict(v) for v in obj]
  if isinstance(obj, dict):
    return {k: dataclass_to_dict(v) for k, v in obj.items()}
  return obj


def to_json(obj: Any, **kwargs) -> str:
  return json.dumps(dataclass_to_dict(obj), **kwargs)


def from_json(cls: Type[T], text: str) -> T:
  return dataclass_from_dict(cls, json.loads(text))


# -- Default-config registry --------------------------------------------------

_DEFAULT_CONFIGS: dict[tuple[str, type], Callable[[], Any]] = {}


def register_default_config(config_type: str, dataclass_type: type,
                            factory: Callable[[], Any]) -> None:
  """Registers a factory producing the default config of a given flavor."""
  _DEFAULT_CONFIGS[(config_type, dataclass_type)] = factory


def default_config(config_type: str, dataclass_type: Type[T],
                   overrides: dict[str, Any] | None = None) -> T:
  """Instantiates a registered default config, with optional deep overrides."""
  key = (config_type, dataclass_type)
  if key not in _DEFAULT_CONFIGS:
    raise KeyError(f'No default config registered for {key}')
  cfg = _DEFAULT_CONFIGS[key]()
  if overrides:
    cfg = update_dataclass(cfg, overrides)
  return cfg


def registered_config_types() -> list[tuple[str, type]]:
  return list(_DEFAULT_CONFIGS)
