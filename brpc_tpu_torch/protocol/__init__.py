from .meta import RpcMeta
from .tpu_std import HEADER_SIZE, MAGIC, pack_frame, read_frame, unpack_frame

__all__ = ["HEADER_SIZE", "MAGIC", "RpcMeta", "pack_frame", "read_frame",
           "unpack_frame"]
