"""Flag system -- process-wide named config with live reload.

A slimmed copy of ``brpc_tpu/butil/flags.py``: flags declare a default
and help text; a flag is *reloadable* (``set_flag`` accepts writes) iff it
registered a validator.  Watchers, listing and the HTTP portal are not
carried over: the port's flags are the device-attachment lane's
(``ici/endpoint.py``), the frame cap (``protocol/tpu_std.py``) and the
KV plane's (``kv/pages.py``, ``kv/transport.py``).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional


class Flag:
    __slots__ = ("name", "value", "default", "help", "validator", "type")

    def __init__(self, name: str, default: Any, help_text: str,
                 validator: Optional[Callable[[Any], bool]]):
        self.name = name
        self.value = default
        self.default = default
        self.help = help_text
        self.validator = validator
        self.type = type(default)

    @property
    def reloadable(self) -> bool:
        return self.validator is not None


_lock = threading.Lock()
_flags: Dict[str, Flag] = {}


def define_flag(name: str, default: Any, help_text: str = "",
                validator: Optional[Callable[[Any], bool]] = None) -> Flag:
    with _lock:
        if name in _flags:
            raise ValueError(f"flag {name!r} already defined")
        f = _flags[name] = Flag(name, default, help_text, validator)
        return f


def get_flag(name: str, default: Any = None) -> Any:
    f = _flags.get(name)
    return f.value if f is not None else default


def set_flag(name: str, value: Any) -> bool:
    """Live-set; only reloadable flags accept writes, and the validator
    must pass.  False when the write is refused."""
    f = _flags.get(name)
    if f is None or not f.reloadable:
        return False
    try:
        if f.type is bool and isinstance(value, str):
            typed = value.lower() in ("1", "true", "yes", "on")
        else:
            typed = f.type(value)
    except (TypeError, ValueError):
        return False
    if not f.validator(typed):
        return False
    f.value = typed
    return True
