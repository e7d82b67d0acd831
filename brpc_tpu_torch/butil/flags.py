"""Flag system -- process-wide named config with live reload.

A slimmed copy of ``brpc_tpu/butil/flags.py``: flags declare a default
and help text; a flag is *reloadable* (``set_flag`` accepts writes) iff it
registered a validator, and watchers (``watch_flag``) run after every
accepted write, so that a live consumer with a cached copy (rpcz's and
lm_telemetry's enable gates) resyncs.  :func:`list_flags` is what the
builtin portal's ``/flags`` page lists and live-sets.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional


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
    for fn in tuple(_watchers.get(name, ())):  # snapshot: a concurrent
        # watch_flag() must not mutate the list we iterate
        try:
            fn(typed)
        except Exception:               # a broken watcher must not veto
            from .logging_util import LOG
            LOG.exception("flag watcher for %r raised", name)
    return True


_watchers: dict = {}


def watch_flag(name: str, fn: Callable[[Any], None]) -> None:
    """Call ``fn(new_value)`` after every successful live-set of
    ``name``.  Watchers are process-lifetime (no unwatch)."""
    _watchers.setdefault(name, []).append(fn)


def list_flags() -> List[Flag]:
    with _lock:
        return sorted(_flags.values(), key=lambda f: f.name)


def any_value(v) -> bool:
    return True


def positive(v) -> bool:
    return v > 0


def non_negative(v) -> bool:
    return v >= 0


# the core flag the port's client reads (``transport/socket_map.py``'s
# health check); the JAX package's other core flag, ``max_body_size``,
# is defined beside its reader in ``protocol/tpu_std.py``
define_flag("health_check_interval_s", 3.0,
            "failed-socket reconnect period", positive)
