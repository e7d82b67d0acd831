"""The port's KV plane.

- :mod:`pages`: the paged batcher's allocator, prefix cache and host
  tier, and the export registry of the disaggregated handoff
  (``KvPageStore``: export, describe, import once, release; owner sweeps
  on socket death; ``drain_settle``);
- :mod:`transport`: :class:`KvTransport` picks the cheapest lane per peer
  (in-process fabric descriptors, or the copy lane's attachment) under
  the closed ``KV_FALLBACK_REASONS`` enum;
- :mod:`disagg`: the two tiers, :class:`PrefillService` and
  :class:`DecodeTierService`.
"""

from .pages import (KV_EVICT_REASONS, PREFIX_CACHE_EVENTS, HostHandle,
                    HostPagePool, KvPageError, KvPageHandle, KvPageStore,
                    PageAllocator, PrefixCache, count_evict, count_prefix,
                    drain_settle, host_inflight_spills, kv_evict_counters,
                    on_socket_closed, outstanding_pages, prefix_event_counters,
                    process_kv_store)
from .transport import (KV_CLOSE_REASONS, KV_FALLBACK_REASONS, KvTransport,
                        count_fallback, kv_fallback_counters, kv_stats)

# the service layer pulls in the model stack; loaded lazily so the
# transport plane's importers (the socket's teardown sweep) stay cheap
_LAZY = {"DecodeTierService": "disagg", "PrefillService": "disagg"}

__all__ = ["KV_EVICT_REASONS", "PREFIX_CACHE_EVENTS", "HostHandle",
           "HostPagePool", "KvPageError", "KvPageHandle", "KvPageStore",
           "PageAllocator", "PrefixCache", "count_evict", "count_prefix",
           "drain_settle", "host_inflight_spills", "kv_evict_counters",
           "on_socket_closed", "outstanding_pages", "prefix_event_counters",
           "process_kv_store",
           "KV_CLOSE_REASONS", "KV_FALLBACK_REASONS", "KvTransport",
           "count_fallback", "kv_fallback_counters", "kv_stats",
           "DecodeTierService", "PrefillService"]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module("." + _LAZY[name], __name__)
        return getattr(mod, name)
    raise AttributeError(name)
