"""fiber — the task runtime and its timer thread.

The port's ``brpc_tpu/fiber/`` holds ``runtime`` and ``timer_thread``
only: the naming services' refreshes run on the timer.  ``butex``,
``versioned_id`` and ``execution_queue`` wait for the port of the
HTTP lanes and the builtin portal."""

from .runtime import (DEFAULT_CONCURRENCY, TaskHandle, TaskRuntime, blocking,
                      global_runtime, set_concurrency, spawn)
from .timer_thread import TimerThread, global_timer_thread

__all__ = ["DEFAULT_CONCURRENCY", "TaskHandle", "TaskRuntime", "TimerThread",
           "blocking", "global_runtime", "global_timer_thread",
           "set_concurrency", "spawn"]
