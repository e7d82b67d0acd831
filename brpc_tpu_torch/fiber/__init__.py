"""fiber — the task runtime, its timer thread and the butex.

The port's ``brpc_tpu/fiber/`` holds ``runtime``, ``timer_thread`` (the
naming services' refreshes and the bvar dump run on it) and ``butex``
(whose waits ``/hotspots/contention`` times; import it from
``fiber.butex``).  ``versioned_id`` and ``execution_queue`` wait for the
native engine's lanes, which use them."""

from .runtime import (DEFAULT_CONCURRENCY, TaskHandle, TaskRuntime, blocking,
                      global_runtime, set_concurrency, spawn)
from .timer_thread import TimerThread, global_timer_thread

__all__ = ["DEFAULT_CONCURRENCY", "TaskHandle", "TaskRuntime", "TimerThread",
           "blocking", "global_runtime", "global_timer_thread",
           "set_concurrency", "spawn"]
