"""Service definition layer (a copy of ``brpc_tpu/server/service.py``'s
core).

A Service is any object whose public methods take ``(controller,
request)`` and return the response.  Requests arrive as raw ``bytes``
and responses are bytes-like (request typing through the JAX package's
``@method`` decorator is not carried over: no port service uses it).
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict


class Service:
    """Optional base class; any duck-typed object works via
    :func:`extract_methods`."""

    @classmethod
    def service_name(cls) -> str:
        return cls.__name__


def extract_methods(service: Any) -> Dict[str, Callable]:
    """Public callables of the service object = its RPC methods."""
    out: Dict[str, Callable] = {}
    for name in dir(service):
        if name.startswith("_"):
            continue
        fn = getattr(service, name)
        if not callable(fn):
            continue
        if name in ("service_name",):
            continue
        # only functions defined by the service class (not inherited
        # object/Service plumbing)
        if inspect.ismethod(fn) or inspect.isfunction(fn):
            out[name] = fn
    return out


def service_name_of(service: Any) -> str:
    if hasattr(service, "service_name"):
        return service.service_name()
    return type(service).__name__
