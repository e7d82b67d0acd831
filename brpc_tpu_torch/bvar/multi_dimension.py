"""Labeled metrics (≈ brpc's src/bvar/multi_dimension.h, "mbvar"):
a map from label-value tuples to an underlying bvar, exported with labels to
Prometheus.

A copy of ``brpc_tpu/bvar/multi_dimension.py``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .variable import Variable


class MultiDimension(Variable):
    def __init__(self, labels: Sequence[str],
                 factory: Callable[[], Variable],
                 name: Optional[str] = None):
        super().__init__()
        self.labels = tuple(labels)
        self._factory = factory
        self._stats: Dict[Tuple[str, ...], Variable] = {}
        self._lock = threading.Lock()
        if name:
            self.expose(name)

    def get_stats(self, label_values: Sequence[str]) -> Variable:
        """Find-or-create the bvar for a label tuple."""
        key = tuple(str(v) for v in label_values)
        if len(key) != len(self.labels):
            raise ValueError(f"expected {len(self.labels)} label values, got {len(key)}")
        var = self._stats.get(key)
        if var is None:
            with self._lock:
                var = self._stats.get(key)
                if var is None:
                    var = self._factory()
                    self._stats[key] = var
        return var

    def has_stats(self, label_values: Sequence[str]) -> bool:
        return tuple(str(v) for v in label_values) in self._stats

    def delete_stats(self, label_values: Sequence[str]) -> None:
        with self._lock:
            self._stats.pop(tuple(str(v) for v in label_values), None)

    def count_stats(self) -> int:
        return len(self._stats)

    def items(self) -> List[Tuple[Tuple[str, ...], Variable]]:
        with self._lock:
            return list(self._stats.items())

    def get_value(self):
        return {k: v.get_value() for k, v in self.items()}

    def describe(self) -> str:
        return f"mbvar(labels={self.labels}, count={self.count_stats()})"


class _ConstVar:
    """Value row for PassiveDimension (get_value protocol only)."""

    __slots__ = ("_v",)

    def __init__(self, v=0):
        self._v = v

    def get_value(self):
        return self._v


class PassiveDimension(MultiDimension):
    """Labeled PASSIVE metric: rows come from a getter at read time
    instead of mutable sub-vars, so one shared snapshot (e.g. the
    native engine's telemetry table) feeds a whole labeled family;
    prometheus.py renders the rows as ``name{label="v"} value``
    exposition lines like any mbvar.  The getter returns
    ``{label_value_or_tuple: numeric}``."""

    def __init__(self, labels, getter, name: Optional[str] = None):
        super().__init__(labels, _ConstVar, name=name)
        self._getter = getter

    def items(self):
        try:
            rows = self._getter()
        except Exception:
            return []
        out = []
        for k, v in rows.items():
            key = (k,) if isinstance(k, str) \
                else tuple(str(x) for x in k)
            out.append((key, _ConstVar(v)))
        return out

    def get_value(self):
        try:
            return dict(self._getter())
        except Exception:
            return {}

    def describe(self) -> str:
        return str(self.get_value())
