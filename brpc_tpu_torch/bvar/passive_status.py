"""PassiveStatus / Status vars (≈ brpc's src/bvar/passive_status.h,
src/bvar/status.h): value-on-read callbacks and settable status values.

A copy of ``brpc_tpu/bvar/passive_status.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

from .variable import Variable


class PassiveStatus(Variable):
    """Value computed by a callback at read time."""

    def __init__(self, getter: Callable[[], object],
                 name: Optional[str] = None):
        super().__init__()
        self._getter = getter
        if name:
            self.expose(name)

    def get_value(self):
        return self._getter()


class StatusVar(Variable):
    """Settable value variable (≈ bvar::Status<T>)."""

    def __init__(self, value=None, name: Optional[str] = None):
        super().__init__()
        self._value = value
        if name:
            self.expose(name)

    def set_value(self, value) -> None:
        self._value = value

    def get_value(self):
        return self._value
