"""Variable base + global registry (≈ brpc's src/bvar/variable.cpp).

A Variable is a named statistic. ``expose(name)`` registers it in the global
name→variable map; the HTTP portal's /vars, /brpc_metrics (Prometheus) and
dump-to-file all walk this registry.

A copy of ``brpc_tpu/bvar/variable.py``.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional

_registry: Dict[str, "Variable"] = {}
# RLock: dropping a registry reference can run Variable.__del__ → hide()
# on the same thread while the lock is held.
_registry_lock = threading.RLock()

_NAME_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_]")


def sanitize_name(name: str) -> str:
    """Normalize to [a-zA-Z0-9_] the way the reference does for /vars."""
    return _NAME_SANITIZE_RE.sub("_", name.strip()).lower()


class Variable:
    """Base statistic. Subclasses implement get_value()/describe()."""

    def __init__(self):
        self._name: Optional[str] = None

    # -- registry --

    def expose(self, name: str, prefix: str = "") -> bool:
        full = sanitize_name(f"{prefix}_{name}" if prefix else name)
        with _registry_lock:
            if full in _registry:
                return False
            if self._name is not None:
                _registry.pop(self._name, None)
            _registry[full] = self
            self._name = full
            return True

    def expose_as(self, prefix: str, name: str) -> bool:
        return self.expose(name, prefix=prefix)

    def hide(self) -> bool:
        with _registry_lock:
            if self._name is None:
                return False
            _registry.pop(self._name, None)
            self._name = None
            return True

    @property
    def name(self) -> Optional[str]:
        return self._name

    # -- value access --

    def get_value(self):
        raise NotImplementedError

    def describe(self) -> str:
        return str(self.get_value())

    def __del__(self):
        try:
            self.hide()
        except Exception:
            pass


def find_exposed(name: str) -> Optional[Variable]:
    with _registry_lock:
        return _registry.get(sanitize_name(name))


def list_exposed() -> List[str]:
    with _registry_lock:
        return sorted(_registry.keys())


def count_exposed() -> int:
    with _registry_lock:
        return len(_registry)


def dump_exposed(filter_prefix: str = "") -> Dict[str, str]:
    """name → describe() snapshot of the whole registry (≈ /vars)."""
    with _registry_lock:
        items = list(_registry.items())
    out = {}
    for name, var in items:
        if filter_prefix and not name.startswith(filter_prefix):
            continue
        try:
            out[name] = var.describe()
        except Exception as e:  # a broken var must not break the dump
            out[name] = f"<error: {e}>"
    return out


def clear_registry_for_tests() -> None:
    with _registry_lock:
        _registry.clear()
