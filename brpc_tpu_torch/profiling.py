"""Profilers behind the /hotspots portal.

The port of ``brpc_tpu/profiling.py`` (role parity with the reference's
hotspots_service: CPU / heap / growth / contention):

- CPU: a sampling profiler over ``sys._current_frames()`` (the server's
  Python work -- dispatch glue, user handlers, client libraries).
- Contention: blocking sections record wait sites while a collection
  window is active (zero overhead otherwise).
- Heap/growth: tracemalloc window diffs.
- Device: a ``torch.profiler`` capture (CPU and, where there is a card,
  CUDA activities), its Chrome trace served as a tarball that loads in
  Perfetto or chrome://tracing -- where the JAX package captures
  ``jax.profiler``'s trace directory.

Outputs: flat top tables, folded stacks (flamegraph.pl format), and a
self-contained HTML flame graph.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# --------------------------------------------------------------------------
# CPU sampling profiler
# --------------------------------------------------------------------------


class CpuProfile:
    def __init__(self, folded: Dict[Tuple[str, ...], int], seconds: float,
                 hz: int, samples: int):
        self.folded = folded
        self.seconds = seconds
        self.hz = hz
        self.samples = samples


def sample_cpu(seconds: float = 5.0, hz: int = 99,
               skip_thread: Optional[int] = None) -> CpuProfile:
    """Sample all Python thread stacks for ``seconds`` at ``hz``.
    ``skip_thread`` excludes the calling (profiling) thread itself."""
    folded: Dict[Tuple[str, ...], int] = defaultdict(int)
    period = 1.0 / max(1, hz)
    end = time.monotonic() + seconds
    n = 0
    me = threading.get_ident()
    while time.monotonic() < end:
        for tid, frame in sys._current_frames().items():
            if tid == me or tid == skip_thread:
                continue
            stack: List[str] = []
            f = frame
            depth = 0
            while f is not None and depth < 64:
                code = f.f_code
                stack.append(f"{os.path.basename(code.co_filename)}:"
                             f"{code.co_name}")
                f = f.f_back
                depth += 1
            if stack:
                folded[tuple(reversed(stack))] += 1
        n += 1
        time.sleep(period)
    return CpuProfile(dict(folded), seconds, hz, n)


def render_folded(folded: Dict[Tuple[str, ...], int]) -> str:
    return "".join(f"{';'.join(k)} {v}\n"
                   for k, v in sorted(folded.items()))


def render_flat(folded: Dict[Tuple[str, ...], int], top: int = 40) -> str:
    self_counts: Dict[str, int] = defaultdict(int)
    total_counts: Dict[str, int] = defaultdict(int)
    total = 0
    for stack, cnt in folded.items():
        total += cnt
        self_counts[stack[-1]] += cnt
        for fn in set(stack):
            total_counts[fn] += cnt
    lines = [f"{'self%':>7} {'total%':>7}  function", "-" * 60]
    for fn, cnt in sorted(self_counts.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"{100*cnt/max(1,total):7.2f} "
                     f"{100*total_counts[fn]/max(1,total):7.2f}  {fn}")
    return "\n".join(lines) + "\n"


def render_flame_html(folded: Dict[Tuple[str, ...], int],
                      title: str = "cpu profile") -> str:
    """Self-contained HTML flame graph (no external assets)."""
    # build the tree
    root: dict = {"name": "all", "value": 0, "children": {}}
    for stack, cnt in folded.items():
        root["value"] += cnt
        node = root
        for fn in stack:
            child = node["children"].get(fn)
            if child is None:
                child = node["children"][fn] = \
                    {"name": fn, "value": 0, "children": {}}
            child["value"] += cnt
            node = child
    rows: List[str] = []
    total = max(1, root["value"])

    import html as _html

    def emit(node, depth, left):
        width = 100.0 * node["value"] / total
        if width < 0.1:
            return
        pct = 100.0 * node["value"] / total
        color = f"hsl({(hash(node['name']) % 60) + 10},70%,60%)"
        name = _html.escape(node["name"])
        label = name if width > 3 else ""
        rows.append(
            f'<div class="f" title="{name} '
            f'({node["value"]} samples, {pct:.1f}%)" '
            f'style="left:{left:.3f}%;width:{width:.3f}%;'
            f'top:{depth * 18}px;background:{color}">{label}</div>')
        child_left = left
        for child in sorted(node["children"].values(),
                            key=lambda c: -c["value"]):
            emit(child, depth + 1, child_left)
            child_left += 100.0 * child["value"] / total

    emit(root, 0, 0.0)
    height = 18 * (1 + max((len(s) for s in folded), default=1))
    return f"""<!doctype html><html><head><meta charset="utf-8">
<title>{title}</title><style>
body{{font:12px monospace;margin:8px}}
.wrap{{position:relative;height:{height}px;border:1px solid #ccc}}
.f{{position:absolute;height:16px;overflow:hidden;white-space:nowrap;
   border-radius:2px;border:1px solid rgba(0,0,0,.15);cursor:default;
   font-size:10px;padding:0 2px;box-sizing:border-box}}
</style></head><body>
<h3>{title}</h3>
<p>hover for samples; <a href="?view=folded">folded</a> |
<a href="?view=flat">flat</a></p>
<div class="wrap">{''.join(rows)}</div>
</body></html>"""


# --------------------------------------------------------------------------
# Contention profiler (butex / fiber blocking wait sites)
# --------------------------------------------------------------------------

_contention_lock = threading.Lock()
_contention_active = False
_contention_sites: Dict[Tuple[str, Tuple[str, ...]], List[float]] = {}
_contention_window = threading.Lock()    # one window at a time
_growth_window = threading.Lock()


def contention_active() -> bool:
    return _contention_active


def timed_wait(kind: str, fn):
    """Run a blocking wait ``fn`` and record its duration against the
    caller's stack when a contention window is open."""
    t0 = time.monotonic()
    ok = fn()
    record_wait(kind, time.monotonic() - t0, skip_frames=2)
    return ok


def record_wait(kind: str, waited_s: float, skip_frames: int = 2) -> None:
    """Called by blocking primitives when a window is active."""
    if not _contention_active or waited_s <= 0:
        return
    f = sys._getframe(skip_frames)
    stack: List[str] = []
    depth = 0
    while f is not None and depth < 24:
        code = f.f_code
        stack.append(f"{os.path.basename(code.co_filename)}:"
                     f"{code.co_name}")
        f = f.f_back
        depth += 1
    key = (kind, tuple(reversed(stack)))
    with _contention_lock:
        _contention_sites.setdefault(key, []).append(waited_s)


def collect_contention(seconds: float = 5.0) -> str:
    """Open a collection window, then report wait sites ranked by total
    waited time (≈ contention profiler semantics).  One window at a
    time: concurrent requests would wipe each other's data."""
    global _contention_active
    if not _contention_window.acquire(blocking=False):
        return "another contention window is active; retry later\n"
    try:
        with _contention_lock:
            _contention_sites.clear()
        _contention_active = True
        try:
            time.sleep(seconds)
        finally:
            _contention_active = False
    finally:
        _contention_window.release()
    with _contention_lock:
        items = [(kind, stack, len(w), sum(w))
                 for (kind, stack), w in _contention_sites.items()]
    items.sort(key=lambda it: -it[3])
    lines = [f"contention over {seconds:.1f}s window",
             f"{'total_ms':>9} {'waits':>6}  kind  wait site", "-" * 72]
    for kind, stack, n, total in items[:50]:
        site = ";".join(stack[-4:])
        lines.append(f"{total*1e3:9.1f} {n:6d}  {kind:<5} {site}")
    if not items:
        lines.append("(no recorded waits — uncontended or idle)")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# Heap / growth (tracemalloc windows)
# --------------------------------------------------------------------------

def collect_growth(seconds: float = 5.0, top: int = 30) -> str:
    import tracemalloc
    if not _growth_window.acquire(blocking=False):
        return "another growth window is active; retry later\n"
    try:
        started_here = not tracemalloc.is_tracing()
        if started_here:
            tracemalloc.start()
        try:
            before = tracemalloc.take_snapshot()
            time.sleep(seconds)
            after = tracemalloc.take_snapshot()
        finally:
            if started_here:
                tracemalloc.stop()
    finally:
        _growth_window.release()
    stats = after.compare_to(before, "lineno")
    lines = [f"heap growth over {seconds:.1f}s window",
             f"{'delta_kb':>9} {'count':>7}  allocation site", "-" * 72]
    for s in stats[:top]:
        if s.size_diff == 0:
            continue
        frame = s.traceback[0]
        lines.append(f"{s.size_diff/1024:9.1f} {s.count_diff:7d}  "
                     f"{os.path.basename(frame.filename)}:{frame.lineno}")
    return "\n".join(lines) + "\n"


def collect_heap(top: int = 30) -> str:
    import tracemalloc
    if not tracemalloc.is_tracing():
        return ("tracemalloc is not tracing; GET /hotspots/growth first "
                "(or start the process with PYTHONTRACEMALLOC=1) for live "
                "heap attribution\n")
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")
    lines = [f"{'kb':>9} {'count':>7}  allocation site", "-" * 72]
    for s in stats[:top]:
        frame = s.traceback[0]
        lines.append(f"{s.size/1024:9.1f} {s.count:7d}  "
                     f"{os.path.basename(frame.filename)}:{frame.lineno}")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# Device (torch.profiler) capture
# --------------------------------------------------------------------------

def collect_device_trace(seconds: float = 3.0) -> Tuple[bytes, str]:
    """Capture a ``torch.profiler`` window of ``seconds`` (CPU activity,
    and CUDA activity where CUDA is available: the kernels of every
    thread, through CUPTI); returns ``(tar.gz bytes, filename)`` holding
    the exported Chrome trace.  Loads in Perfetto / chrome://tracing."""
    import io
    import shutil
    import tarfile
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    tmp = tempfile.mkdtemp(prefix="hotspots_device_")
    try:
        with profile(activities=activities) as prof:
            time.sleep(seconds)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(tmp, "trace.json"))
        bio = io.BytesIO()
        with tarfile.open(fileobj=bio, mode="w:gz") as tar:
            tar.add(tmp, arcname="device_trace")
        name = f"device_trace_{int(time.time())}.tar.gz"
        return bio.getvalue(), name
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
