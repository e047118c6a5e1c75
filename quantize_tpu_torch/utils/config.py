"""Hierarchical YAML configuration system.

Re-implements the configuration surface of the reference framework
(``utils/cfg_parser.py:103`` in JingInAI/Quantize) so that the same YAML corpus
style drives this framework:

* ``_base_:`` recursive inheritance (single path or list of paths),
* deep dict merge with ``_delete_`` / ``_replace_`` escape hatches,
* dotted-key CLI overrides (``a.b.c=value``),
* string values auto-typed to int/float/bool/None,
* attribute access that returns ``None`` for missing keys,
* a frozen global singleton reachable via :func:`get_cfg`.

The implementation is new code written for this framework; only the observable
semantics follow the reference.
"""
from __future__ import annotations

import os
from typing import Any, Iterable, Mapping

import yaml

_cfg: "Config | None" = None


def get_cfg() -> "Config | None":
    """Return the global frozen config (set by :meth:`Config.freeze`)."""
    return _cfg


def parse_value(value: Any) -> Any:
    """Coerce strings coming from YAML/CLI into typed Python values.

    Mirrors the reference's value parsing (``utils/cfg_parser.py:20-71``):
    recursive over lists and dicts; ``"true"``/``"false"`` (case-insensitive)
    become bools, ``"none"``/``"null"`` become None, numeric strings become
    int/float, everything else stays a string.
    """
    if isinstance(value, list):
        return [parse_value(v) for v in value]
    if isinstance(value, tuple):
        return tuple(parse_value(v) for v in value)
    if isinstance(value, dict):
        return {k: parse_value(v) for k, v in value.items()}
    if isinstance(value, bool) or value is None:
        return value
    if isinstance(value, str):
        low = value.lower()
        if low in ("true", "false"):
            return low == "true"
        if low in ("none", "null"):
            return None
        try:
            return int(value)
        except ValueError:
            pass
        try:
            return float(value)
        except ValueError:
            pass
        return value
    return value


def set_by_dotted_key(obj: dict, key: str, value: Any) -> None:
    """Set ``obj['a']['b']['c'] = value`` given key ``'a.b.c'``."""
    keys = str(key).split(".")
    for k in keys[:-1]:
        obj = obj.setdefault(k, {})
        if not isinstance(obj, dict):
            raise TypeError(f"Cannot set nested key through non-dict at {k!r}")
    obj[keys[-1]] = value


def deep_merge(dst: dict, src: Mapping) -> dict:
    """Deep-merge ``src`` into ``dst`` in place, honoring escape markers.

    Matches the reference merge semantics (``utils/cfg_parser.py:173-197``):

    * if both sides hold dicts, recurse — unless ``src[k]`` carries
      ``_delete_: true`` (drop the key entirely) or ``_replace_: true``
      (overwrite instead of merging);
    * otherwise assign a DEEP COPY, stripping any spent markers. The copy
      matters: assigning ``src``'s nested dicts by reference would let a
      later merge into ``dst`` recurse into — and silently mutate — the
      source tree. That exact aliasing once let a ``/conv1``-scoped
      override leak into the shared ``default`` config for every layer
      resolved afterwards (caught by the round-5 ACIQ network golden case;
      pinned by ``test_config.py::test_merge_never_aliases_or_mutates_src``
      and ``test_golden_models.py`` resnet18_aciq_act8).
    """
    import copy

    for k, v in src.items():
        if k in dst and isinstance(v, dict) and isinstance(dst[k], dict):
            if v.get("_delete_"):
                dst.pop(k)
            elif v.get("_replace_"):
                v = dict(v)
                v.pop("_replace_")
                dst[k] = copy.deepcopy(v)
            else:
                deep_merge(dst[k], v)
        else:
            if isinstance(v, dict):
                if v.get("_delete_"):
                    continue
                v = {kk: vv for kk, vv in v.items() if kk not in ("_delete_", "_replace_")}
            dst[k] = copy.deepcopy(v)
    return dst


def dict_merge(*dicts: Mapping | None) -> dict:
    """Merge several dicts left-to-right with :func:`deep_merge` semantics."""
    out: dict = {}
    for d in dicts:
        if d:
            deep_merge(out, d)
    return out


class Config:
    """Nested dict-as-attributes config tree.

    Missing attributes read as ``None`` (reference behavior,
    ``utils/cfg_parser.py:260-264``) so call sites can probe optional keys
    without try/except.

    Examples::

        >>> cfg = Config({'a': 1, 'b': {'c': 2}})
        >>> cfg.a, cfg.b.c, cfg['b.c'], cfg.missing
        (1, 2, 2, None)
    """

    _RESERVED = ("cfg", "_name")

    def __init__(self, obj: Mapping | None = None, name: str = "config"):
        object.__setattr__(self, "cfg", {})
        object.__setattr__(self, "_name", name)
        if obj:
            for k, v in obj.items():
                v = parse_value(v)
                self.cfg[k] = v
                object.__setattr__(self, str(k), Config(v, name=str(k)) if isinstance(v, dict) else v)

    # -- merging ----------------------------------------------------------
    def merge_from_yaml(self, cfg_file: str) -> "Config":
        """Load YAML, recursively resolving ``_base_`` first (depth-first).

        ``_base_`` paths are resolved relative to the current working
        directory first, then relative to the including file's directory.
        """
        cfg_file = os.path.abspath(os.path.expanduser(cfg_file))
        with open(cfg_file) as f:
            data = yaml.safe_load(f) or {}
        bases = data.pop("_base_", [])
        if not isinstance(bases, list):
            bases = [bases]
        for base in bases:
            cand = base
            if not os.path.exists(cand):
                cand = os.path.join(os.path.dirname(cfg_file), base)
            self.merge_from_yaml(cand)
        self.merge_from_dict(data)
        return self

    def merge_from_dict(self, args: Mapping) -> "Config":
        deep_merge(self.cfg, parse_value(dict(args)))
        self._rebuild()
        return self

    def merge_from_list(self, args: Iterable[str]) -> "Config":
        """Merge ``['a.b=1', 'c=x']``-style CLI overrides."""
        staged: dict = {}
        for arg in args:
            if "=" not in arg:
                raise ValueError(f"CLI override must be k=v, got {arg!r}")
            k, v = arg.split("=", 1)
            set_by_dotted_key(staged, k, v)
        return self.merge_from_dict(staged)

    def _rebuild(self) -> None:
        # Drop stale attribute mirrors, then re-project self.cfg.
        for k in list(self.__dict__):
            if k not in self._RESERVED:
                object.__delattr__(self, k)
        for k, v in self.cfg.items():
            object.__setattr__(self, str(k), Config(v, name=str(k)) if isinstance(v, dict) else v)

    def freeze(self) -> "Config":
        """Publish this config as the global singleton."""
        global _cfg
        self._rebuild()
        _cfg = self
        return self

    # -- access -----------------------------------------------------------
    def to_dict(self) -> dict:
        return _deepcopy_dict(self.cfg)

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def __getitem__(self, key: str) -> Any:
        parts = str(key).split(".")
        node: Any = self
        for p in parts:
            if not isinstance(node, Config) or p not in node.__dict__:
                raise KeyError(f"Key {key!r} not found in config")
            node = object.__getattribute__(node, p)
        return node

    def __setattr__(self, name: str, value: Any) -> None:
        self.cfg[name] = value.cfg if isinstance(value, Config) else value
        object.__setattr__(self, name, value)

    def __contains__(self, key: str) -> bool:
        try:
            self[key]
            return True
        except KeyError:
            return False

    def __getattr__(self, name: str) -> Any:
        # Only called when normal lookup fails: missing keys read as None.
        if name.startswith("__"):
            raise AttributeError(name)
        return None

    def __bool__(self) -> bool:
        return bool(self.cfg)

    def __str__(self, indent: int = 0) -> str:
        lines = []
        for k, v in self.cfg.items():
            pad = " " * indent
            if isinstance(v, dict):
                lines.append(f"{pad}{k}:")
                lines.append(Config(v).__str__(indent + 2))
            else:
                lines.append(f"{pad}{k}: {v}")
        return "\n".join(l for l in lines if l)

    def __repr__(self) -> str:
        return f"Config({self.cfg!r})"

    def dump_yaml(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


def _deepcopy_dict(d: Any) -> Any:
    if isinstance(d, dict):
        return {k: _deepcopy_dict(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_deepcopy_dict(v) for v in d]
    return d
