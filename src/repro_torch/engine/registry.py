"""Strategy registry: a flat name -> implementation table, so drivers
select methods by string and new methods plug in with a decorator."""
from __future__ import annotations

from typing import Dict, List

STRATEGIES: Dict[str, object] = {}


def register(name: str):
    """Class decorator: ``@register("stocfl")`` installs an instance."""
    def deco(cls):
        cls.name = name
        STRATEGIES[name] = cls()
        return cls
    return deco


def get_strategy(name: str):
    """Resolve a registered strategy instance by name (KeyError lists
    the registered names on a miss)."""
    if name not in STRATEGIES:
        raise KeyError(f"unknown strategy {name!r}; registered: {sorted(STRATEGIES)}")
    return STRATEGIES[name]


def list_strategies() -> List[str]:
    """Sorted names of every registered strategy."""
    return sorted(STRATEGIES)
