"""Prometheus text exposition of the variable registry
(≈ brpc's src/brpc/builtin/prometheus_metrics_service.cpp).

A copy of ``brpc_tpu/bvar/prometheus.py``.
"""

from __future__ import annotations

from typing import List

from .latency_recorder import LatencyRecorder
from .multi_dimension import MultiDimension
from .variable import _registry, _registry_lock


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(value) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, (int, float)):
        return repr(float(value)) if isinstance(value, float) else str(value)
    return "0"  # non-numeric vars are skipped by caller


def _is_numeric(value) -> bool:
    return isinstance(value, (int, float)) and not isinstance(value, bool)


def render_prometheus() -> str:
    with _registry_lock:
        items = list(_registry.items())
    lines: List[str] = []
    emitted = set()
    # composites first so their sub-view names take precedence over the
    # independently-exposed sub-vars (LatencyRecorder.expose registers both)
    items.sort(key=lambda kv: not isinstance(kv[1], LatencyRecorder))
    for name, var in items:
        if name in emitted:
            continue
        try:
            if isinstance(var, LatencyRecorder):
                emitted.update({f"{name}_latency", f"{name}_max_latency",
                                f"{name}_qps", f"{name}_count"})
                lines.append(f"# TYPE {name}_latency gauge")
                lines.append(f"{name}_latency {_fmt(var.latency())}")
                lines.append(f'{name}_latency{{quantile="0.5"}} {_fmt(var.p50())}')
                lines.append(f'{name}_latency{{quantile="0.9"}} {_fmt(var.p90())}')
                lines.append(f'{name}_latency{{quantile="0.99"}} {_fmt(var.p99())}')
                lines.append(f"# TYPE {name}_max_latency gauge")
                lines.append(f"{name}_max_latency {_fmt(var.max_latency())}")
                lines.append(f"# TYPE {name}_qps gauge")
                lines.append(f"{name}_qps {_fmt(var.qps())}")
                lines.append(f"# TYPE {name}_count counter")
                lines.append(f"{name}_count {_fmt(var.count())}")
            elif isinstance(var, MultiDimension):
                lines.append(f"# TYPE {name} gauge")
                for key, sub in var.items():
                    v = sub.get_value()
                    if _is_numeric(v):
                        labels = ",".join(
                            f'{ln}="{_escape_label(lv)}"'
                            for ln, lv in zip(var.labels, key))
                        lines.append(f"{name}{{{labels}}} {_fmt(v)}")
            else:
                v = var.get_value()
                if _is_numeric(v):
                    lines.append(f"# TYPE {name} gauge")
                    lines.append(f"{name} {_fmt(v)}")
        except Exception:
            continue
    return "\n".join(lines) + "\n"
