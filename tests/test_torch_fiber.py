"""The port's fiber runtime and timer thread, case by case as
``tests/test_fiber.py``'s ``TestRuntime`` and ``TestTimerThread``, each
run on the port and on the JAX package in the same process (the same
inputs, the same outcome)."""

import threading
import time

import pytest

from brpc_tpu import fiber as jfiber
from brpc_tpu_torch import fiber as tfiber


@pytest.fixture(params=["port", "jax"])
def fib(request):
    return tfiber if request.param == "port" else jfiber


class Countdown:
    """``CountdownEvent`` of the JAX package's fiber, which the port does
    not carry: ``n`` signals open the gate."""

    def __init__(self, n):
        self._n = n
        self._lock = threading.Lock()
        self._done = threading.Event()

    def signal(self):
        with self._lock:
            self._n -= 1
            if self._n <= 0:
                self._done.set()

    def wait(self, timeout):
        return self._done.wait(timeout)


def test_exports_runtime_and_timer_only():
    # the runtime and the timer, and since the butex, versioned ids and
    # the execution queue were ported, every name the JAX package's
    # fiber/__init__.py exports
    assert set(tfiber.__all__) == {
        "DEFAULT_CONCURRENCY", "TaskHandle", "TaskRuntime", "TimerThread",
        "blocking", "global_runtime", "global_timer_thread",
        "set_concurrency", "spawn", "Butex", "CountdownEvent", "IdPool",
        "global_id_pool", "INVALID_CALL_ID", "ExecutionQueue",
        "TaskIterator"}
    assert all(hasattr(jfiber, name) for name in tfiber.__all__)
    assert tfiber.DEFAULT_CONCURRENCY == jfiber.DEFAULT_CONCURRENCY


def test_spawn_join_result(fib):
    h = fib.spawn(lambda a, b: a + b, 2, 3)
    assert h.result(5) == 5
    assert h.done


def test_exception_propagates(fib):
    def boom():
        raise ValueError("x")
    h = fib.spawn(boom)
    h.join(5)
    with pytest.raises(ValueError):
        h.result(1)


def test_many_tasks(fib):
    rt = fib.TaskRuntime(concurrency=4)
    counter = []
    lock = threading.Lock()

    def inc():
        with lock:
            counter.append(1)

    handles = [rt.spawn(inc) for _ in range(200)]
    for h in handles:
        assert h.join(10)
    assert len(counter) == 200
    rt.shutdown()


def test_blocking_tasks_dont_deadlock_pool(fib):
    """More blocked tasks than core workers: the pool must grow."""
    rt = fib.TaskRuntime(concurrency=2, max_workers=64)
    gate = threading.Event()
    started = Countdown(8)

    def block():
        started.signal()
        gate.wait(10)

    hs = [rt.spawn(block) for _ in range(8)]
    assert started.wait(5), "pool failed to grow past blocked workers"
    gate.set()
    for h in hs:
        assert h.join(5)
    rt.shutdown()


def test_urgent_goes_first(fib):
    rt = fib.TaskRuntime(concurrency=1)
    order = []
    gate = threading.Event()
    rt.spawn(lambda: gate.wait(5))
    rt.spawn(lambda: order.append("bg"))
    rt.spawn(lambda: order.append("urgent"), urgent=True)
    gate.set()
    deadline = time.monotonic() + 5
    while len(order) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert order == ["urgent", "bg"]
    rt.shutdown()


def test_work_stealing_spreads_a_workers_spawns(fib):
    """Tasks spawned from a worker land on its local queue; an idle
    worker steals them, so a blocked spawner does not strand them."""
    rt = fib.TaskRuntime(concurrency=2)
    ran = Countdown(4)
    gate = threading.Event()

    def parent():
        for _ in range(4):
            rt.spawn(ran.signal)
        gate.wait(5)            # the spawner blocks: others must steal

    h = rt.spawn(parent)
    assert ran.wait(5)
    gate.set()
    assert h.join(5)
    rt.shutdown()


def test_schedule_fires(fib):
    tt = fib.TimerThread()
    fired = threading.Event()
    tt.schedule(fired.set, delay_s=0.05)
    assert fired.wait(5)
    assert tt.triggered_count >= 1
    tt.stop()


def test_unschedule(fib):
    tt = fib.TimerThread()
    fired = []
    tid = tt.schedule(lambda: fired.append(1), delay_s=0.2)
    assert tt.unschedule(tid)
    time.sleep(0.4)
    assert not fired
    assert not tt.unschedule(tid)  # already cancelled
    assert (tt.scheduled_count, tt.cancelled_count) == (1, 1)
    tt.stop()


def test_ordering(fib):
    tt = fib.TimerThread()
    order = []
    done = threading.Event()
    tt.schedule(lambda: order.append("b"), delay_s=0.15)
    tt.schedule(lambda: (order.append("a"), None), delay_s=0.05)
    tt.schedule(lambda: (order.append("c"), done.set()), delay_s=0.25)
    assert done.wait(5)
    assert order == ["a", "b", "c"]
    tt.stop()


def test_nearer_deadline_preempts_sleep(fib):
    tt = fib.TimerThread()
    fired = threading.Event()
    tt.schedule(lambda: None, delay_s=30)   # sleeping until far future
    time.sleep(0.05)
    t0 = time.monotonic()
    tt.schedule(fired.set, delay_s=0.05)    # must wake the thread
    assert fired.wait(5)
    assert time.monotonic() - t0 < 5
    tt.stop()


def test_naming_refresh_rides_the_global_timer(tmp_path):
    """``file://`` naming refreshes through ``global_timer_thread`` (the
    JAX package's schedule), not a thread of its own."""
    from brpc_tpu_torch.client.naming_service import create_naming_service
    p = tmp_path / "servers"
    p.write_text("10.0.0.1:80\n")
    tt = tfiber.global_timer_thread()
    before = tt.scheduled_count
    ns = create_naming_service(f"file://{p}")
    try:
        assert tt.scheduled_count == before + 1
        assert ns._timer_id and ns._timer_id in tt._entries
    finally:
        ns.stop()
    assert ns._timer_id not in tt._entries
