"""Config system: nested attribute-dicts with recursive YAML composition
(port of mpsfm_tpu/config.py).

Mirrors the reference's semantics (mpsfm/baseclass.py:16-28 and
mpsfm/utils/tools.py:24-72): every pipeline object declares a
``default_conf``; user configs are deep-merged over defaults; YAML files
may declare ``defaults:`` lists that are loaded recursively, including the
``name@target`` remapping form that grafts a file under a sub-key.
PyYAML is imported by ``load_cfg`` only, so the objects built on
``BaseClass`` need no YAML parser.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any


class Config(dict):
    """A dict with attribute access and deep-merge. Keys are strings."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, dict):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, (list, tuple)):
            return type(value)(Config._wrap(v) for v in value)
        return value

    @classmethod
    def create(cls, data: dict | None = None) -> "Config":
        return cls._wrap(dict(data or {}))

    def merged(self, override: dict | None) -> "Config":
        """Deep merge: values in ``override`` win; nested dicts merge recursively."""
        out = Config.create(copy.deepcopy(dict(self)))
        if not override:
            return out
        for key, val in override.items():
            if key in out and isinstance(out[key], dict) and isinstance(val, dict):
                out[key] = Config.create(out[key]).merged(val)
            else:
                out[key] = Config._wrap(copy.deepcopy(val) if isinstance(val, (dict, list)) else val)
        return out

    def to_dict(self) -> dict:
        def unwrap(v):
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(unwrap(x) for x in v)
            return v

        return unwrap(self)


def load_cfg(path: str | Path, _seen: set | None = None) -> Config:
    """Load a YAML config with recursive ``defaults:`` composition.

    ``defaults:`` entries are either plain names (sibling YAML files merged
    at the root) or ``name@sub.key`` (merged under the dotted sub-key),
    matching the reference's loader (mpsfm/utils/tools.py:24-72).
    Later entries and the file's own body override earlier ones.
    """
    import yaml

    path = Path(path)
    if path.suffix == "":
        path = path.with_suffix(".yaml")
    _seen = _seen or set()
    if path in _seen:
        raise ValueError(f"Circular config defaults involving {path}")
    _seen = _seen | {path}

    with open(path) as f:
        raw = yaml.safe_load(f) or {}

    base = Config.create({})
    for entry in raw.pop("defaults", []) or []:
        if "@" in entry:
            name, target = entry.split("@", 1)
        else:
            name, target = entry, None
        sub = load_cfg(path.parent / name, _seen)
        if target:
            wrapped: dict = {}
            node = wrapped
            keys = target.split(".")
            for k in keys[:-1]:
                node[k] = {}
                node = node[k]
            node[keys[-1]] = sub.to_dict()
            sub = Config.create(wrapped)
        base = base.merged(sub)

    return base.merged(raw)


def summarize_cfg(conf: dict, indent: int = 0) -> str:
    """Human-readable recursive dump of every knob (reference: summarize_cfg)."""
    lines = []
    for key in sorted(conf):
        val = conf[key]
        pad = "  " * indent
        if isinstance(val, dict):
            lines.append(f"{pad}{key}:")
            lines.append(summarize_cfg(val, indent + 1))
        else:
            lines.append(f"{pad}{key}: {val}")
    return "\n".join(lines)


class BaseClass:
    """Config-merging base for pipeline objects (reference: mpsfm/baseclass.py).

    Subclasses declare ``default_conf``; ``__init__(conf, ...)`` merges the
    user conf over defaults, then calls ``_propagate_conf`` and ``_init``.
    """

    default_conf: dict = {}

    def __init__(self, conf: dict | None = None, *args, **kwargs):
        self.conf = Config.create(self.default_conf).merged(conf)
        self._propagate_conf()
        self._init(*args, **kwargs)

    def _propagate_conf(self):
        pass

    def _init(self, *args, **kwargs):
        pass

    def log(self, *args, level: int = 1, **kwargs):
        if int(self.conf.get("verbose", 0)) >= level:
            print(*args, **kwargs)
