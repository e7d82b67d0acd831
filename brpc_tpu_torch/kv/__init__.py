"""The port's KV plane: the paged batcher's allocator, prefix cache and
host tier (:mod:`pages`).  The disaggregated handoff (the export
registry, ``transport`` and ``disagg``) is not ported yet."""

from .pages import (KV_EVICT_REASONS, PREFIX_CACHE_EVENTS, HostHandle,
                    HostPagePool, KvPageError, PageAllocator, PrefixCache,
                    count_evict, count_prefix, host_inflight_spills,
                    kv_evict_counters, prefix_event_counters)

__all__ = ["KV_EVICT_REASONS", "PREFIX_CACHE_EVENTS", "HostHandle",
           "HostPagePool", "KvPageError", "PageAllocator", "PrefixCache",
           "count_evict", "count_prefix", "host_inflight_spills",
           "kv_evict_counters", "prefix_event_counters"]
