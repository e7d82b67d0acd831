from .controller import ServerController
from .server import Server, ServerOptions
from .service import Service, grpc_streaming, method, raw_method

__all__ = ["Server", "ServerController", "ServerOptions", "Service",
           "grpc_streaming", "method", "raw_method"]
