from .endpoint import EndPoint, parse_endpoint
from .status import Errno, Status

__all__ = ["EndPoint", "Errno", "Status", "parse_endpoint"]
