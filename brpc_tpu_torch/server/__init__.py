from .controller import ServerController
from .server import Server
from .service import Service

__all__ = ["Server", "ServerController", "Service"]
