from .controller import ServerController
from .server import Server, ServerOptions
from .service import Service

__all__ = ["Server", "ServerController", "ServerOptions", "Service"]
