"""Extension<T> — the universal name→plugin registry
(≈ brpc's src/brpc/extension.h:38-53): case-insensitive names,
process-global per category, used by naming services, load balancers and
concurrency limiters so user plugins register alongside builtins.

A copy of ``brpc_tpu/butil/extension.py``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Generic, List, Optional, TypeVar

T = TypeVar("T")


class Extension(Generic[T]):
    def __init__(self, category: str):
        self.category = category
        self._lock = threading.Lock()
        self._map: Dict[str, T] = {}

    def register(self, name: str, instance: T,
                 allow_override: bool = False) -> None:
        key = name.lower()
        with self._lock:
            if key in self._map and not allow_override:
                raise ValueError(
                    f"{self.category} extension {name!r} already registered")
            self._map[key] = instance

    def find(self, name: str) -> Optional[T]:
        return self._map.get(name.lower())

    def list(self) -> List[str]:
        with self._lock:
            return sorted(self._map)


_registries: Dict[str, Extension] = {}
_registries_lock = threading.Lock()


def extension(category: str) -> Extension:
    """Shared registry for a category (lazily created)."""
    with _registries_lock:
        reg = _registries.get(category)
        if reg is None:
            reg = _registries[category] = Extension(category)
        return reg
