"""Variable trend recording — the live graphs behind /vars?expand=NAME.

≈ the reference portal's per-variable flot charts (vars_service.cpp +
js/flot): once a variable is expanded, a Sampler records its value every
second into a bounded ring; the portal renders the ring as an inline
SVG sparkline (self-contained — no JS assets).

A copy of ``brpc_tpu/bvar/trend.py``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from .sampler import Sampler, _sampler_thread
from .variable import find_exposed

WINDOW_SAMPLES = 120          # 2 minutes at 1Hz


class _TrendSampler(Sampler):
    def __init__(self, name: str):
        self.name = name
        self.ring: Deque[Tuple[float, float]] = deque(maxlen=WINDOW_SAMPLES)
        self.last_seen = time.monotonic()

    def take_sample(self) -> None:
        v = find_exposed(self.name)
        if v is None:
            return
        try:
            val = float(v.get_value())
        except (TypeError, ValueError):
            return
        self.ring.append((time.monotonic(), val))


_lock = threading.Lock()
_trends: Dict[str, _TrendSampler] = {}


def track(name: str) -> Optional[_TrendSampler]:
    """Start (or refresh) trend recording for an exposed variable."""
    if find_exposed(name) is None:
        return None
    with _lock:
        t = _trends.get(name)
        if t is None:
            t = _trends[name] = _TrendSampler(name)
            _sampler_thread.add(t)
        t.last_seen = time.monotonic()
        # lazily retire trends nobody has looked at for 10 minutes
        for k in [k for k, v in _trends.items()
                  if time.monotonic() - v.last_seen > 600]:
            _trends.pop(k, None)
    return t


def render_sparkline_svg(samples: List[Tuple[float, float]],
                         width: int = 480, height: int = 80) -> str:
    if len(samples) < 2:
        return ("<svg xmlns='http://www.w3.org/2000/svg' "
                f"width='{width}' height='{height}'>"
                "<text x='8' y='20' font-size='12'>collecting… "
                "refresh in a few seconds</text></svg>")
    vals = [v for _, v in samples]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    n = len(samples)
    pts = " ".join(
        f"{i * (width - 10) / (n - 1) + 5:.1f},"
        f"{height - 18 - (v - lo) / span * (height - 30):.1f}"
        for i, (_, v) in enumerate(samples))
    return (f"<svg xmlns='http://www.w3.org/2000/svg' width='{width}' "
            f"height='{height}' style='background:#fafafa;"
            f"border:1px solid #ddd'>"
            f"<polyline fill='none' stroke='#3366cc' stroke-width='1.5' "
            f"points='{pts}'/>"
            f"<text x='5' y='12' font-size='10'>max {hi:g}</text>"
            f"<text x='5' y='{height - 4}' font-size='10'>min {lo:g} · "
            f"{n}s window</text></svg>")
