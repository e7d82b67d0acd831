"""Task runtime — the concurrency substrate of the framework.

Capability parity with bthread's M:N scheduler
(brpc's src/bthread/task_group.h, task_control.h): spawn cheap
tasks, steal-balanced workers, parking when idle, urgent vs background
start.  Design differences, deliberate:

- CPython's GIL makes user-space context switching pointless for *compute*;
  what the RPC stack needs from the runtime is (a) cheap task handoff,
  (b) workers that never sit on a blocked task when runnable work exists,
  (c) bounded thread growth when tasks block on IO/butex — the same
  deadlock-avoidance job as the reference's ``usercode_in_pthread`` backup
  pool (brpc's src/brpc/details/usercode_backup_pool.h:30-60).
  So: a dynamic pool with a shared run queue, LIFO slot for urgent starts,
  and on-demand worker growth up to ``max_workers`` when all workers are
  busy/blocked.
- This Python runtime is the control-plane engine: the Python
  transport's consumers (``transport/event_dispatcher.py``) and the
  messages they spawn run on it; the native engine's loops
  (``brpc_tpu_torch/native``) are threads of their own.

Wake-up discipline (≈ ParkingLot, parking_lot.h): every COOPERATIVE
path is event-driven — spawn() notifies a parked worker the moment an
item lands (shared queue or a local queue another worker can steal),
and butex/join/socket waits announce themselves via begin_blocking()
so a replacement starts immediately when runnable work would starve.
The only poll in the design is the 50ms starvation monitor, and it
exists for the one case no event can cover: arbitrary user code
blocking a worker WITHOUT telling anyone (third-party sleeps, raw
syscalls) — the same hole the reference plugs with its
usercode_in_pthread backup pool.  The monitor runs only while work is
queued and retires itself when traffic stops.

A copy of ``brpc_tpu/fiber/runtime.py``.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Deque, List, Optional

from ..butil.logging_util import LOG
from ..bvar.passive_status import PassiveStatus
from ..bvar.reducer import Adder

DEFAULT_CONCURRENCY = 9          # ≈ reference default 8 workers + 1 (bthread.cpp:102)
MAX_WORKERS = 256
IDLE_TIMEOUT_S = 30.0
STARVATION_CHECK_S = 0.05

_tls = threading.local()         # current worker's runtime (for blocking marks)


class TaskHandle:
    """Join-able handle for a spawned task (≈ bthread_t + bthread_join)."""

    __slots__ = ("_done", "_result", "_exc", "fn_name")

    def __init__(self, fn_name: str = ""):
        self._done = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self.fn_name = fn_name

    def join(self, timeout: Optional[float] = None) -> bool:
        with blocking():
            from .. import profiling
            if profiling.contention_active():
                return profiling.timed_wait(
                    "join", lambda: self._done.wait(timeout))
            return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        with blocking():
            done = self._done.wait(timeout)
        if not done:
            raise TimeoutError(f"task {self.fn_name} not done")
        if self._exc is not None:
            raise self._exc
        return self._result


class TaskRuntime:
    def __init__(self, concurrency: int = DEFAULT_CONCURRENCY,
                 max_workers: int = MAX_WORKERS, name: str = "fiber"):
        self.concurrency = concurrency
        self.max_workers = max_workers
        self.name = name
        self._queue: Deque = deque()          # FIFO background + LIFO urgent
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._workers = 0
        self._idle = 0
        self._blocked = 0        # workers inside cooperative blocking marks
        self._dequeues = 0       # progress counter for the starvation monitor
        self._monitor_running = False
        self._shutdown = False
        self._spawned = Adder()
        self._worker_seq = 0
        # per-worker local queues (≈ bthread's WorkStealingQueue,
        # work_stealing_queue.h): a worker spawning a task pushes it to
        # its OWN queue (LIFO pop keeps the continuation cache-hot);
        # other workers steal FIFO when their own queue and the shared
        # queue are dry.  Guarded by self._lock for list mutations.
        self._local_queues: List = []

    # -- introspection (exposed as bvars by Server) --

    @property
    def worker_count(self) -> int:
        return self._workers

    @property
    def pending_count(self) -> int:
        return len(self._queue) + sum(len(q) for q in self._local_queues)

    def spawn(self, fn: Callable, *args, urgent: bool = False,
              name: str = "") -> TaskHandle:
        """Start a task (≈ bthread_start_urgent/background). ``urgent``
        tasks go to the front of the shared queue; a task spawned FROM a
        worker lands on that worker's local queue (work stealing)."""
        handle = TaskHandle(name or getattr(fn, "__name__", "task"))
        item = (fn, args, handle)
        wsq = getattr(_tls, "wsq", None) \
            if getattr(_tls, "runtime", None) is self else None
        if wsq is not None and not urgent and wsq.push(item):
            self._spawned.update(1)
            with self._lock:
                if self._shutdown:
                    pass          # drain path below still runs the task
                if self._idle > 0:
                    self._not_empty.notify()
                elif self._effective_workers_locked() < self.concurrency:
                    self._add_worker_locked()
                else:
                    self._ensure_monitor_locked()
            return handle
        with self._lock:
            if self._shutdown:
                raise RuntimeError("runtime is shut down")
            if urgent:
                self._queue.appendleft(item)
            else:
                self._queue.append(item)
            self._spawned.update(1)
            if self._idle > 0:
                self._not_empty.notify()
            elif self._effective_workers_locked() < self.concurrency:
                self._add_worker_locked()
            else:
                # all workers busy at target concurrency: let the
                # starvation monitor grow the pool if they're blocked
                self._ensure_monitor_locked()
        return handle

    def _effective_workers_locked(self) -> int:
        """Workers doing (or able to do) CPU work: excludes ones parked in
        cooperative blocking sections."""
        return self._workers - self._blocked

    # -- blocking compensation (≈ usercode_in_pthread deadlock avoidance) --

    def begin_blocking(self) -> None:
        """Called by framework primitives (butex/join/socket waits) before a
        worker blocks: spawns a replacement if runnable work would starve."""
        with self._lock:
            self._blocked += 1
            if ((self._queue or any(self._local_queues))
                    and self._idle == 0
                    and self._workers < self.max_workers
                    and self._effective_workers_locked() < self.concurrency):
                self._add_worker_locked()

    def end_blocking(self) -> None:
        with self._lock:
            self._blocked -= 1

    def _ensure_monitor_locked(self) -> None:
        if not self._monitor_running:
            self._monitor_running = True
            t = threading.Thread(target=self._monitor_loop,
                                 name=f"{self.name}_monitor", daemon=True)
            t.start()

    def _monitor_loop(self) -> None:
        """Detects starvation from *uncooperative* blocking (arbitrary user
        code sleeping/IO-ing on a worker): if the queue is non-empty and no
        dequeue happened across a check interval, add a worker."""
        import time as _time
        idle_rounds = 0
        while True:
            with self._lock:
                last = self._dequeues
            _time.sleep(STARVATION_CHECK_S)
            with self._lock:
                if self._shutdown:
                    self._monitor_running = False
                    return
                if self._queue or any(self._local_queues):
                    idle_rounds = 0
                    if (self._dequeues == last and self._idle == 0
                            and self._workers < self.max_workers):
                        self._add_worker_locked()
                else:
                    idle_rounds += 1
                    if idle_rounds > 100:
                        self._monitor_running = False
                        return

    def _add_worker_locked(self) -> None:
        self._worker_seq += 1
        self._workers += 1
        t = threading.Thread(target=self._worker_loop,
                             name=f"{self.name}_w{self._worker_seq}",
                             daemon=True)
        t.start()

    def _steal_locked(self, my_wsq):
        """One item from the shared queue or another worker's local
        queue; None when everything is dry.  Runs under self._lock."""
        if self._queue:
            return self._queue.popleft()
        for wsq in self._local_queues:
            if wsq is my_wsq:
                continue
            ok, item = wsq.steal()
            if ok:
                return item
        return None

    def _worker_loop(self) -> None:
        from ..butil.work_stealing_queue import WorkStealingQueue
        my_wsq = WorkStealingQueue()
        _tls.runtime = self
        _tls.wsq = my_wsq
        with self._lock:
            self._local_queues.append(my_wsq)
        core = True
        try:
            while True:
                ok, item = my_wsq.pop()       # own continuations first
                if not ok:
                    with self._lock:
                        item = self._steal_locked(my_wsq)
                        while item is None and not self._shutdown:
                            self._idle += 1
                            try:
                                # extra (non-core) workers retire on idle
                                core = self._workers <= self.concurrency
                                signalled = self._not_empty.wait(
                                    None if core else IDLE_TIMEOUT_S)
                            finally:
                                self._idle -= 1
                            item = self._steal_locked(my_wsq)
                            if item is None and not signalled and not core:
                                self._workers -= 1
                                return
                        if item is None:      # shutdown and dry
                            self._workers -= 1
                            return
                        self._dequeues += 1
                else:
                    # GIL-atomic enough for the starvation monitor's
                    # progress check; no global lock on the hot path
                    self._dequeues += 1
                fn, args, handle = item
                try:
                    handle._result = fn(*args)
                except BaseException as e:
                    handle._exc = e
                    LOG.error("task %s raised: %s\n%s", handle.fn_name, e,
                              traceback.format_exc())
                finally:
                    handle._done.set()
        finally:
            # retirement/shutdown: strand no local work — move remnants
            # to the shared queue and wake a peer
            with self._lock:
                try:
                    self._local_queues.remove(my_wsq)
                except ValueError:
                    pass
                moved = False
                while True:
                    ok, item = my_wsq.steal()
                    if not ok:
                        break
                    self._queue.append(item)
                    moved = True
                if moved:
                    self._not_empty.notify()
            _tls.wsq = None

    def shutdown(self, wait: bool = True) -> None:
        with self._lock:
            self._shutdown = True
            self._not_empty.notify_all()
        if wait:
            # workers drain the queue then retire; poll until none remain
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                with self._lock:
                    if self._workers == 0 and not self._queue:
                        return
                time.sleep(0.005)


_global_runtime: Optional[TaskRuntime] = None
_global_lock = threading.Lock()


def global_runtime() -> TaskRuntime:
    global _global_runtime
    if _global_runtime is None:
        with _global_lock:
            if _global_runtime is None:
                _global_runtime = TaskRuntime()
    return _global_runtime


def spawn(fn: Callable, *args, urgent: bool = False, name: str = "") -> TaskHandle:
    return global_runtime().spawn(fn, *args, urgent=urgent, name=name)


def set_concurrency(n: int) -> None:
    """≈ bthread_setconcurrency."""
    global_runtime().concurrency = n


class blocking:
    """Context manager marking the current worker as blocked so the
    runtime compensates with another worker.  No-op off worker threads.
    Framework blocking primitives (butex waits, call joins, socket waits)
    use this; user code doing long blocking calls on a fiber should too.
    """

    def __enter__(self):
        rt = getattr(_tls, "runtime", None)
        self._rt = rt
        if rt is not None:
            rt.begin_blocking()
        return self

    def __exit__(self, *exc):
        if self._rt is not None:
            self._rt.end_blocking()
        return False
