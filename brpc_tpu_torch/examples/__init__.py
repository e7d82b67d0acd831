"""Runnable demos of the port, one per script of ``brpc_tpu``'s
``examples/``, under the same file names.

Each module runs as ``python -m brpc_tpu_torch.examples.<name>`` and
takes ``--device`` (default ``cuda``): a CUDA device where CUDA is absent
raises, and ``--device cpu`` runs it on the CPU.  Importing a module
starts nothing.  ``README.md`` beside them lists what each shows and what
a ``brpc_tpu`` handler changes to run on the port.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Callable, Optional, Sequence

import torch

from ..parallel.spmd import SpmdPool, init_world
from ..utils.device import resolve_device


def parse_args(doc: str, argv: Optional[Sequence[str]] = None,
               extra: Optional[Callable] = None) -> argparse.Namespace:
    """The example's arguments: ``--device`` resolved to a
    ``torch.device`` (raises for cuda without CUDA), and whatever
    ``extra(parser)`` adds."""
    parser = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    if extra is not None:
        extra(parser)
    args = parser.parse_args(argv)
    args.device = resolve_device(args.device)
    return args


def default_world(device: torch.device) -> int:
    """How many ranks a multi-rank example runs when not told: brpc_tpu's
    take every device JAX sees; the port runs one rank per card (NCCL
    refuses two ranks on one card), and one on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


class Ranks:
    """``world`` ranks of one process group on ``device``'s backend
    (NCCL on cuda, gloo on cpu), as a context manager: :meth:`run` runs
    one function on every rank and returns the results in rank order.
    One rank joins from this process (so its kernel launches count
    here); more run in a :class:`~..parallel.spmd.SpmdPool`, where the
    function travels by import path."""

    def __init__(self, world: int, device: torch.device):
        self.world, self.device = world, device
        self._tmp = None
        self._pool = None

    def __enter__(self):
        self._tmp = tempfile.TemporaryDirectory(prefix="example_pg_")
        try:
            if self.world == 1:
                init_world(0, 1, self.device,
                           os.path.join(self._tmp.name, "rendezvous"))
            else:
                self._pool = SpmdPool(self.world, self.device, self._tmp.name)
        except BaseException:
            self._tmp.cleanup()
            raise
        return self

    def run(self, fn: Callable, *args) -> list:
        if self._pool is None:
            return [fn(*args)]
        return self._pool.run(fn, *args)

    def __exit__(self, *exc):
        try:
            if self._pool is not None:
                self._pool.close()
            else:
                torch.distributed.destroy_process_group()
        finally:
            self._tmp.cleanup()


def rank_device(device_type: str) -> torch.device:
    """This rank's device: card ``rank`` on cuda (as ``init_world`` set
    it), the CPU otherwise."""
    if device_type == "cuda":
        return torch.device("cuda", torch.distributed.get_rank())
    return torch.device("cpu")
