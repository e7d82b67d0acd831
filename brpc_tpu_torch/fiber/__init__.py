"""fiber — the task runtime, its timer thread, the butex, versioned call
ids and the execution queue: the names ``brpc_tpu/fiber/__init__.py``
exports."""

from .runtime import (TaskRuntime, TaskHandle, spawn, global_runtime,
                      set_concurrency, blocking, DEFAULT_CONCURRENCY)
from .butex import Butex, CountdownEvent
from .versioned_id import IdPool, global_id_pool, INVALID_CALL_ID
from .execution_queue import ExecutionQueue, TaskIterator
from .timer_thread import TimerThread, global_timer_thread

__all__ = ["Butex", "CountdownEvent", "DEFAULT_CONCURRENCY", "ExecutionQueue",
           "INVALID_CALL_ID", "IdPool", "TaskHandle", "TaskIterator",
           "TaskRuntime", "TimerThread", "blocking", "global_id_pool",
           "global_runtime", "global_timer_thread", "set_concurrency",
           "spawn"]
