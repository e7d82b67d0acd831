"""Device-attachment lane -- RPC payloads that stay on the device.

The port of ``brpc_tpu/ici/``: the connection carries *descriptors* and
acks while the tensor stays where it lies, the way an RDMA message
carries keys instead of payload bytes.

- :mod:`fabric`     -- how posted tensors reach their redeemer (the
  in-process registry, and the CUDA IPC fabric for other processes on
  the same card);
- :mod:`cuda_ipc`   -- the CUDA IPC export and pull behind it
  (``ops/csrc/ipc.cu``);
- :mod:`block_pool` -- bounded, recycled landing buffers on the card
  (the registered-memory analogue);
- :mod:`endpoint`   -- per-connection window + ack flow control, the
  descriptor lifecycle, the send and redeem paths, the TTL sweep;
- :mod:`attachment` -- the user-facing :class:`DeviceAttachment` and the
  descriptor codec.
"""

from .attachment import DeviceAttachment
from .block_pool import DeviceBlockPool, default_device_pool
from .endpoint import IciEndpoint, ici_enabled
from .fabric import local_domain_id

__all__ = ["DeviceAttachment", "DeviceBlockPool", "default_device_pool",
           "IciEndpoint", "ici_enabled", "local_domain_id"]
