from .socket import Socket

__all__ = ["Socket"]
