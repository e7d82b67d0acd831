"""bvar — thread-local-aggregated metrics (L2). SURVEY.md §2.3 inventory.

A copy of ``brpc_tpu/bvar/__init__.py``.
"""

from .variable import (Variable, find_exposed, list_exposed, count_exposed,
                       dump_exposed, clear_registry_for_tests, sanitize_name)
from .reducer import Adder, Maxer, Miner, IntRecorder, Reducer
from .window import Window, PerSecond
from .percentile import Percentile
from .latency_recorder import LatencyRecorder
from .passive_status import PassiveStatus, StatusVar
from .multi_dimension import MultiDimension
from .sampler import tick_once_for_tests, add_sampler, remove_sampler, Sampler
from .collector import Collector, Collected
from .prometheus import render_prometheus
from .default_variables import expose_default_variables
from .dump import dump_once, ensure_dumper
