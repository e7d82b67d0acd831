"""butil — the base library: the names ``brpc_tpu/butil/__init__.py``
exports, from the port's copies."""

from .iobuf import (IOBuf, IOPortal, IOBufAppender, IOBufReader, Block,
                    BlockPool, HostBlockPool, DEFAULT_BLOCK_SIZE,
                    default_block_pool)
from .resource_pool import (ResourcePool, ObjectPool, INVALID_ID,
                            id_slot, id_version, make_id)
from .doubly_buffered import DoublyBufferedData
from .endpoint import EndPoint, parse_endpoint, device_endpoint
from .flat_map import CaseIgnoredFlatMap, MRUCache, BoundedQueue
from .fast_rand import (fast_rand, fast_rand_less_than, fast_rand_in,
                        fast_rand_double)
from .crc32c import crc32c, crc32c_extend, hash_bytes64, fmix64
from .time_utils import monotonic_us, monotonic_ms, gettimeofday_us, Timer
from .status import Status, Errno
from .logging_util import LOG, vlog, log_every_n, log_first_n
