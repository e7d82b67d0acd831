"""The port's pure-Python leaves, each held beside its JAX twin: the
same cases (``tests/test_butil.py``, ``tests/test_parity_items.py``,
``tests/test_sanitizers.py``, ``tests/test_fiber.py``) run through both
packages, and where a leaf computes a value (``crc32c``,
``hash_bytes64``, ``fmix64``, the containers after a seeded sequence of
operations, the endpoint helpers) the port's equals the JAX package's
on the same seeded input."""

import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = ("brpc_tpu", "brpc_tpu_torch")


def _ns(pkg: str) -> SimpleNamespace:
    mods = {name: importlib.import_module(f"{pkg}.{name}") for name in (
        "butil", "butil.crc32c", "butil.resource_pool",
        "butil.simple_data_pool", "butil.periodic_task", "butil.sanitizers",
        "butil.flat_map", "butil.endpoint", "butil.flags", "fiber",
        "fiber.butex", "fiber.versioned_id", "fiber.execution_queue")}
    return SimpleNamespace(**{k.replace(".", "_"): v for k, v in mods.items()})


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _ns(request.param)


@pytest.fixture(scope="module")
def both():
    return _ns("brpc_tpu"), _ns("brpc_tpu_torch")


# -- crc32c / hashes: the port's values equal JAX's ------------------------

def test_crc32c_and_hashes_equal_jax_on_seeded_bytes(both):
    j, t = both
    rng = np.random.default_rng(16)
    for n in (0, 1, 7, 64, 1000, 4099):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert t.butil.crc32c(data) == j.butil.crc32c(data)
        assert t.butil.hash_bytes64(data) == j.butil.hash_bytes64(data)
        half = n // 2
        assert t.butil.crc32c_extend(t.butil.crc32c(data[:half]),
                                     data[half:]) == t.butil.crc32c(data)
    for x in rng.integers(0, 2 ** 63, 32, dtype=np.uint64).tolist():
        assert t.butil.fmix64(x) == j.butil.fmix64(x)


def test_crc32c_known_vectors(pkg):
    b = pkg.butil
    assert b.crc32c(b"") == 0
    assert b.crc32c(b"123456789") == 0xE3069283
    assert b.crc32c(b"a" * 32) == b.crc32c_extend(b.crc32c(b"a" * 16),
                                                  b"a" * 16)


# -- ResourcePool / ObjectPool (tests/test_butil.py:17-56) -------------------

def test_resource_pool_acquire_address_release(pkg):
    pool = pkg.butil.ResourcePool(factory=dict)
    rid, obj = pool.acquire()
    assert pool.address(rid) is obj
    assert pool.release(rid)
    assert pool.address(rid) is None
    assert not pool.release(rid)


def test_resource_pool_version_bump_on_reuse(pkg):
    b = pkg.butil
    pool = b.ResourcePool(factory=dict)
    rid1, _ = pool.acquire()
    pool.release(rid1)
    rid2, _ = pool.acquire()
    assert b.id_slot(rid1) == b.id_slot(rid2)
    assert b.id_version(rid1) != b.id_version(rid2)
    assert pool.address(rid1) is None
    assert pool.address(rid2) is not None


def test_resource_pool_concurrent_churn(pkg):
    pool = pkg.butil.ResourcePool(factory=object)
    errors = []

    def churn():
        try:
            for _ in range(2000):
                rid, obj = pool.acquire()
                assert pool.address(rid) is obj
                assert pool.release(rid)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    ts = [threading.Thread(target=churn) for _ in range(4)]
    for th in ts:
        th.start()
    for th in ts:
        th.join()
    assert not errors
    assert pool.live_count == 0


def test_object_pool(pkg):
    resets = []
    pool = pkg.butil.ObjectPool(factory=list,
                                reset=lambda x: (x.clear(), resets.append(1)))
    a = pool.get()
    a.append(1)
    pool.put(a)
    b = pool.get()
    assert b is a and b == [] and resets == [1]


def test_resource_pool_ids_equal_jax(both):
    """The same acquire/release sequence hands out the same ids."""
    j, t = both
    rng = np.random.default_rng(7)
    pools = [j.butil.ResourcePool(factory=dict),
             t.butil.ResourcePool(factory=dict)]
    held = [[], []]
    for step, pick in zip(rng.integers(0, 3, 200).tolist(),
                          rng.integers(0, 1 << 16, 200).tolist()):
        outs = []
        for pool, live in zip(pools, held):
            if step and live:
                rid = live.pop(pick % len(live))
                outs.append(pool.release(rid))
            else:
                rid, _ = pool.acquire()
                live.append(rid)
                outs.append(rid)
        assert outs[0] == outs[1]
    assert held[0] == held[1]
    assert j.butil.INVALID_ID == t.butil.INVALID_ID
    assert j.butil.make_id(3, 5) == t.butil.make_id(3, 5)


# -- SimpleDataPool (tests/test_parity_items.py) -----------------------------

def test_simple_data_pool_recycles(pkg):
    made = []

    def factory():
        obj = {"n": len(made)}
        made.append(obj)
        return obj

    pool = pkg.butil_simple_data_pool.SimpleDataPool(factory, max_cached=2)
    a = pool.borrow()
    b = pool.borrow()
    assert pool.created == 2
    pool.give_back(a)
    c = pool.borrow()
    assert c is a
    assert pool.created == 2
    pool.give_back(b)
    pool.give_back(c)
    assert pool.free_count == 2


def test_simple_data_pool_over_cap_destroys(both):
    seen = []
    for mod in both:
        destroyed = []
        pool = mod.butil_simple_data_pool.SimpleDataPool(
            dict, destroy=destroyed.append, max_cached=1)
        a, b = pool.borrow(), pool.borrow()
        pool.give_back(a)
        pool.give_back(b)
        seen.append((pool.created, pool.borrowed, pool.free_count,
                     len(destroyed), destroyed[0] is b))
    assert seen[0] == seen[1] == (2, 0, 1, 1, True)


# -- PeriodicTask (tests/test_parity_items.py) -------------------------------

def test_periodic_task_runs_and_stops(pkg):
    runs = []
    t = pkg.butil_periodic_task.PeriodicTask(
        0.05, lambda: runs.append(time.monotonic()))
    time.sleep(0.4)
    t.stop()
    n = len(runs)
    assert 2 <= n <= 10, n
    time.sleep(0.2)
    assert len(runs) == n


def test_periodic_task_return_false_stops(pkg):
    runs = []

    def once():
        runs.append(1)
        return False

    t = pkg.butil_periodic_task.PeriodicTask(0.05, once)
    time.sleep(0.3)
    assert len(runs) == 1
    assert t.run_count == 1
    t.stop()


def test_periodic_task_retargets_interval(pkg):
    stamps = []

    def fn():
        stamps.append(time.monotonic())
        return 0.2

    t = pkg.butil_periodic_task.PeriodicTask(0.02, fn)
    time.sleep(0.5)
    t.stop()
    assert len(stamps) >= 2
    assert stamps[1] - stamps[0] >= 0.15


# -- sanitizers (tests/test_sanitizers.py) and the butex watchdog branch -----

@pytest.fixture
def san(pkg):
    s = pkg.butil_sanitizers
    s.reset_for_tests()
    yield pkg
    pkg.butil_flags.set_flag("stall_watchdog_s", 0.0)
    pkg.butil_flags.set_flag("debug_lock_order", False)
    s.reset_for_tests()


def test_stall_watchdog_reports_stuck_butex_wait_once(san):
    san.butil_flags.set_flag("stall_watchdog_s", 0.05)
    bx = san.fiber_butex.Butex(0)
    t = threading.Thread(target=lambda: bx.wait(0, timeout=5.0),
                         daemon=True)
    t.start()
    time.sleep(0.15)
    # the butex's wait registered itself with the watchdog (the branch
    # the port's butex took back)
    assert "butex" in [w[0] for w in san.butil_sanitizers._waits.values()]
    assert san.butil_sanitizers.check_stalls() == 1
    assert san.butil_sanitizers.check_stalls() == 0
    bx.wake_all()
    t.join(2)
    assert not t.is_alive()


def test_countdown_wait_is_watched(san):
    san.butil_flags.set_flag("stall_watchdog_s", 0.05)
    ev = san.fiber_butex.CountdownEvent(1)
    t = threading.Thread(target=lambda: ev.wait(5.0), daemon=True)
    t.start()
    time.sleep(0.15)
    assert "countdown" in [w[0] for w in
                           san.butil_sanitizers._waits.values()]
    assert san.butil_sanitizers.check_stalls() == 1
    ev.signal()
    t.join(2)
    assert not t.is_alive()


def test_no_report_under_threshold(san):
    san.butil_flags.set_flag("stall_watchdog_s", 5.0)
    bx = san.fiber_butex.Butex(0)
    t = threading.Thread(target=lambda: bx.wait(0, timeout=2.0),
                         daemon=True)
    t.start()
    time.sleep(0.05)
    assert san.butil_sanitizers.check_stalls() == 0
    bx.wake_all()
    t.join(2)


def test_lock_order_cycle_detected(san):
    s = san.butil_sanitizers
    san.butil_flags.set_flag("debug_lock_order", True)
    a, b = s.DebugLock("A"), s.DebugLock("B")
    with a:
        with b:
            pass
    assert s.lock_order_warnings() == 0

    def inverted():
        with b:
            with a:
                pass

    for _ in range(2):
        t = threading.Thread(target=inverted)
        t.start()
        t.join(2)
        assert s.lock_order_warnings() == 1
    with a:
        with b:
            pass
    assert s.lock_order_warnings() == 1


def test_consistent_order_never_warns(san):
    s = san.butil_sanitizers
    san.butil_flags.set_flag("debug_lock_order", True)
    a, b = s.DebugLock("A2"), s.DebugLock("B2")
    for _ in range(5):
        with a:
            with b:
                pass
    assert s.lock_order_warnings() == 0


def test_execution_queue_lock_is_a_debug_lock(san):
    q = san.fiber_execution_queue.ExecutionQueue(lambda it: list(it),
                                                 name="sanit_probe_7")
    assert isinstance(q._lock, san.butil_sanitizers.DebugLock)
    assert q._lock.name == "execq:sanit_probe"


# -- IdPool (tests/test_fiber.py:106-180) ------------------------------------

def test_id_create_lock_unlock_destroy(pkg):
    pool = pkg.fiber.IdPool()
    cid = pool.create(data={"x": 1})
    ok, data = pool.lock(cid)
    assert ok and data == {"x": 1}
    pool.unlock(cid)
    assert pool.valid(cid)
    ok, _ = pool.lock(cid)
    assert ok
    assert pool.unlock_and_destroy(cid)
    assert not pool.valid(cid)
    ok, _ = pool.lock(cid)
    assert not ok


def test_id_error_runs_handler_when_unlocked(pkg):
    pool = pkg.fiber.IdPool()
    seen = []

    def on_error(cid, data, code, text):
        seen.append((code, text))
        pool.unlock_and_destroy(cid)

    cid = pool.create(data="d", on_error=on_error)
    assert pool.error(cid, 1008, "timeout")
    assert seen == [(1008, "timeout")]
    assert not pool.valid(cid)


def test_id_error_queued_while_locked(pkg):
    pool = pkg.fiber.IdPool()
    seen = []

    def on_error(cid, data, code, text):
        seen.append(code)
        pool.unlock_and_destroy(cid)

    cid = pool.create(data="d", on_error=on_error)
    ok, _ = pool.lock(cid)
    assert ok
    assert pool.error(cid, 1009)
    assert seen == []
    pool.unlock(cid)
    assert seen == [1009]
    assert not pool.valid(cid)


def test_id_ranged_versions_address_same_call(pkg):
    pool = pkg.fiber.IdPool()
    cid = pool.create_ranged("call", None, version_range=4)
    for k in range(4):
        assert pool.valid(cid + k)
    ok, data = pool.lock(cid + 2)
    assert ok and data == "call"
    assert pool.unlock_and_destroy(cid + 2)
    for k in range(4):
        assert not pool.valid(cid + k)


def test_id_join_wakes_on_destroy(pkg):
    pool = pkg.fiber.IdPool()
    cid = pool.create("c")
    done = []

    def joiner():
        pool.join(cid, timeout=10)
        done.append(1)

    t = threading.Thread(target=joiner)
    t.start()
    time.sleep(0.05)
    pool.lock(cid)
    pool.unlock_and_destroy(cid)
    t.join(5)
    assert done


def test_id_lock_contention_serializes(pkg):
    pool = pkg.fiber.IdPool()
    cid = pool.create([])
    order = []

    def worker(tag):
        ok, _ = pool.lock(cid)
        assert ok
        order.append(tag)
        time.sleep(0.01)
        pool.unlock(cid)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(5)]
    for th in ts:
        th.start()
    for th in ts:
        th.join()
    assert sorted(order) == list(range(5))


def test_id_values_equal_jax(both):
    """The same create/destroy sequence gives the same ids."""
    outs = []
    for mod in both:
        pool = mod.fiber.IdPool()
        ids = []
        for k in range(6):
            cid = pool.create_ranged(k, None, version_range=1 + k % 3)
            ids.append(cid)
            if k % 2:
                pool.lock(cid)
                pool.unlock_and_destroy(cid)
        outs.append(ids)
    assert outs[0] == outs[1]
    assert both[0].fiber.INVALID_CALL_ID == both[1].fiber.INVALID_CALL_ID


# -- ExecutionQueue (tests/test_fiber.py:201-241) ----------------------------

def test_execq_batched_consumption(pkg):
    got = []
    done = threading.Event()

    def executor(it):
        for item in it:
            got.append(item)
        if len(got) >= 100:
            done.set()

    q = pkg.fiber.ExecutionQueue(executor)
    for i in range(100):
        q.execute(i)
    assert done.wait(5)
    assert q.join(5)
    assert got == list(range(100))


def test_execq_high_priority_lane(pkg):
    got = []
    gate = threading.Event()

    def executor(it):
        gate.wait(5)
        for item in it:
            got.append(item)

    q = pkg.fiber.ExecutionQueue(executor)
    q.execute("a")
    time.sleep(0.05)
    q.execute("b")
    q.execute("hi", high_priority=True)
    gate.set()
    assert q.join(5)
    assert got.index("hi") < got.index("b")


def test_execq_stop_rejects(pkg):
    q = pkg.fiber.ExecutionQueue(lambda it: [x for x in it])
    q.stop()
    assert q.execute(1) is False


def test_execq_concurrent_producers(pkg):
    got = []
    lock = threading.Lock()

    def executor(it):
        for item in it:
            with lock:
                got.append(item)

    q = pkg.fiber.ExecutionQueue(executor)
    ts = [threading.Thread(target=lambda base=b: [
        q.execute(base * 100 + i) for i in range(100)]) for b in range(4)]
    for th in ts:
        th.start()
    for th in ts:
        th.join()
    assert q.join(5)
    assert sorted(got) == list(range(400))
    assert q.pending == 0


def test_execq_stopped_iterator_sees_flag(pkg):
    flags = []
    gate = threading.Event()

    def executor(it):
        gate.wait(5)
        flags.append(it.stopped)
        list(it)

    q = pkg.fiber.ExecutionQueue(executor)
    q.execute(1)
    time.sleep(0.05)
    q.execute(2)
    q.stop()
    gate.set()
    assert q.join(5)
    assert flags[-1] is True


# -- containers (tests/test_butil.py:117-150) --------------------------------

def test_case_ignored_map(pkg):
    m = pkg.butil.CaseIgnoredFlatMap()
    m["Content-Type"] = "application/json"
    assert m["content-type"] == "application/json"
    assert "CONTENT-TYPE" in m
    assert list(m.keys()) == ["Content-Type"]
    del m["Content-type"]
    assert len(m) == 0


def test_mru_cache(pkg):
    c = pkg.butil.MRUCache(2)
    c.put(1, "a")
    c.put(2, "b")
    c.get(1)
    c.put(3, "c")
    assert c.get(2) is None
    assert c.get(1) == "a" and c.get(3) == "c"


def test_containers_equal_jax_after_seeded_ops(both):
    rng = np.random.default_rng(11)
    keys = ["Accept", "accept", "Host", "HOST", "X-Id", "x-id", "Te"]
    ops = [(int(rng.integers(0, 4)), keys[int(rng.integers(0, len(keys)))],
            int(rng.integers(0, 100))) for _ in range(300)]
    states = []
    for mod in both:
        m = mod.butil.CaseIgnoredFlatMap()
        c = mod.butil.MRUCache(4)
        log = []
        for op, key, val in ops:
            if op == 0:
                m[key] = val
                c.put(key, val)
            elif op == 1:
                log.append((m.get(key), c.get(key)))
            elif op == 2 and key in m:
                del m[key]
            else:
                log.append((key in m, key in c, len(m), len(c)))
        states.append((log, list(m.items()), list(m.keys())))
    assert states[0] == states[1]


# -- endpoint helpers (tests/test_butil.py:133-150) --------------------------

def test_endpoint_helpers_equal_jax(both):
    j, t = both
    assert t.butil_endpoint.my_hostname() == j.butil_endpoint.my_hostname()
    assert t.butil_endpoint.hostname_to_ip("localhost") == \
        j.butil_endpoint.hostname_to_ip("localhost")
    assert str(t.butil.device_endpoint("pod0", 3)) == \
        str(j.butil.device_endpoint("pod0", 3)) == "ici://pod0/3"
    ep = t.butil.parse_endpoint("ici://pod0/3")
    assert ep.is_device and ep == t.butil.device_endpoint("pod0", 3)


def test_butil_exports_match_jax(both):
    j, t = both
    names = [n for n in dir(j.butil) if not n.startswith("_")
             and not isinstance(getattr(j.butil, n), type(j.butil))]
    assert [n for n in names if not hasattr(t.butil, n)] == []
