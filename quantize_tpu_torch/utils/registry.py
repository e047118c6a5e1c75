"""Name -> object registries with "did you mean" suggestions.

Functional equivalent of the reference's ``utils/register.py:13`` registry and
``utils/tools.py:90`` fuzzy matching, written fresh for this framework.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Iterable


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance (iterative DP)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def most_similar(name: str, candidates: Iterable[str]) -> str | None:
    """Return the candidate with smallest edit distance to ``name``."""
    cands = list(candidates)
    if not cands:
        return None
    return min(cands, key=lambda c: edit_distance(name.lower(), c.lower()))


class Registry(dict):
    """A dict specialized for registering callables/classes by name.

    Names are lowercased. Registering a duplicate name warns and overwrites
    (matching the reference's tolerant behavior).
    """

    def __init__(self, name: str = "registry"):
        super().__init__()
        self.name = name

    def register(self, obj: Callable | None = None, *, name: str | None = None):
        """Use as ``@REG.register`` or ``@REG.register(name='x')`` or call directly."""
        def _do(o: Callable) -> Callable:
            key = (name or o.__name__).lower()
            if key in self:
                warnings.warn(f"{self.name}: duplicate registration of {key!r}; overwriting")
            self[key] = o
            return o

        if obj is None:
            return _do
        return _do(obj)

    def register_dict(self, mapping: dict) -> None:
        for k, v in mapping.items():
            key = k.lower()
            if key in self:
                warnings.warn(f"{self.name}: duplicate registration of {key!r}; overwriting")
            self[key] = v

    def build(self, name: str, *args: Any, **kwargs: Any) -> Any:
        return self.lookup(name)(*args, **kwargs)

    def lookup(self, name: str) -> Any:
        key = str(name).lower()
        if key not in self:
            hint = most_similar(key, self.keys())
            raise KeyError(
                f"{name!r} is not registered in {self.name}"
                + (f"; did you mean {hint!r}?" if hint else "")
            )
        return self[key]

