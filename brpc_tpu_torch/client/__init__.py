from .channel import Channel, ChannelOptions, RpcError
from .controller import Controller
from .parallel_channel import SKIP, ParallelChannel, SelectiveChannel
from .partition_channel import DynamicPartitionChannel, PartitionChannel

__all__ = ["Channel", "ChannelOptions", "Controller",
           "DynamicPartitionChannel", "ParallelChannel", "PartitionChannel",
           "RpcError", "SKIP", "SelectiveChannel"]
