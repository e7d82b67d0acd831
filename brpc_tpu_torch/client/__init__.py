from .channel import Channel, ChannelOptions, RpcError
from .controller import Controller

__all__ = ["Channel", "ChannelOptions", "Controller", "RpcError"]
