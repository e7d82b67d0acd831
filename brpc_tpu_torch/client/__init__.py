from .channel import Channel, ChannelOptions, RpcError
from .controller import Controller, start_cancel
from .parallel_channel import SKIP, ParallelChannel, SelectiveChannel
from .partition_channel import DynamicPartitionChannel, PartitionChannel

__all__ = ["Channel", "ChannelOptions", "Controller",
           "DynamicPartitionChannel", "ParallelChannel", "PartitionChannel",
           "RpcError", "SKIP", "SelectiveChannel", "start_cancel"]
