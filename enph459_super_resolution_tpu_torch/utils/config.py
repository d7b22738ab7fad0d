"""Typed configuration system.

The reference scatters configuration across module-level UPPERCASE
constants edited in place, thin argparse shims, two metadata.json schemas,
and notebook dicts (SURVEY.md §5).  Here one mechanism subsumes them:
dataclass configs with JSON round-trip, dotted-path overrides
(``--set sim.gain_px_per_deg=3.3`` style), and environment variable
overlays (``SRTPU_<FIELD>``), so every CLI and orchestrator shares the
same declarative story.

The port's copy of ``enph459_super_resolution_tpu/utils/config.py``
(plain Python).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Type, TypeVar

T = TypeVar("T")


def to_dict(cfg: Any) -> Dict:
    """Dataclass (possibly nested) -> plain JSON-able dict."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    return cfg


def from_dict(cls: Type[T], data: Dict) -> T:
    """Build a dataclass from a dict, recursing into dataclass fields and
    rejecting unknown keys (typo safety the reference's constants lack)."""
    import typing

    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: "
                       f"{sorted(unknown)}")
    # resolve string annotations (`from __future__ import annotations`
    # stringifies every field type, so fields[...].type is NOT a class)
    try:
        hints = typing.get_type_hints(cls)
    except Exception:
        hints = {name: f.type for name, f in fields.items()}
    kwargs = {}
    for name, value in data.items():
        ftype = hints.get(name)
        target = ftype if isinstance(ftype, type) else None
        if target and dataclasses.is_dataclass(target) and \
                isinstance(value, dict):
            kwargs[name] = from_dict(target, value)
        elif isinstance(value, list):
            kwargs[name] = tuple(tuple(v) if isinstance(v, list) else v
                                 for v in value)
        else:
            kwargs[name] = value
    return cls(**kwargs)


def save(cfg: Any, path: str) -> None:
    with open(path, "w") as fp:
        json.dump(to_dict(cfg), fp, indent=2)


def load(cls: Type[T], path: str) -> T:
    with open(path) as fp:
        return from_dict(cls, json.load(fp))


def _coerce(text: str, current: Any) -> Any:
    if isinstance(current, bool):
        return text.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(text)
    if isinstance(current, float):
        return float(text)
    return text


def apply_overrides(cfg: T, overrides) -> T:
    """Apply ``["a.b=3", "name=x"]`` dotted-path overrides, returning a new
    (replaced) dataclass; types are coerced from the current field value."""
    for item in overrides or ():
        path, _, text = item.partition("=")
        keys = path.strip().split(".")
        cfg = _replace_path(cfg, keys, text)
    return cfg


def _replace_path(cfg, keys, text):
    field = keys[0]
    current = getattr(cfg, field)
    if len(keys) == 1:
        return dataclasses.replace(cfg, **{field: _coerce(text, current)})
    return dataclasses.replace(
        cfg, **{field: _replace_path(current, keys[1:], text)})


def apply_env(cfg: T, prefix: str = "SRTPU_") -> T:
    """Overlay environment variables: ``SRTPU_<FIELD>`` (top level only)."""
    for f in dataclasses.fields(cfg):
        env = os.environ.get(prefix + f.name.upper())
        if env is not None:
            cfg = dataclasses.replace(
                cfg, **{f.name: _coerce(env, getattr(cfg, f.name))})
    return cfg
