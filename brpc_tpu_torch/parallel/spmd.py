"""One program per rank: process-group set-up and a pool of rank workers.

:func:`init_world` joins this process to a process group through a
``file://`` rendezvous (a ``FileStore``; no TCP port), with the device's
backend (NCCL on cuda, gloo on cpu) and a timeout on every collective, so
that a hang fails instead of waiting for ever.

:class:`SpmdPool` spawns ``world`` worker processes that join one group
and then run the functions they are handed, every rank the same function
on the same arguments, until the pool is closed; :func:`run_spmd` runs one
function in a fresh pool.  The functions travel by import path (module
and name), so they live in a module the workers can import; the workers
import nothing the caller did not name.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh_transport import backend_for

DEFAULT_TIMEOUT_S = 60.0


def init_world(rank: int, world: int, device="cuda", init_file: str = "",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the default process group as ``rank`` of ``world``; returns
    the rank's device.  On cuda each rank takes card ``rank``: NCCL
    refuses two ranks on one card, so ``world`` may not exceed the cards
    there are."""
    dev = resolve_device(device)
    if not init_file:
        raise ValueError("init_file names the rendezvous file")
    if dev.type == "cuda":
        if world > torch.cuda.device_count():
            raise RuntimeError(
                f"{world} ranks on {torch.cuda.device_count()} card(s): "
                f"NCCL runs one rank per card")
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    dist.init_process_group(
        backend_for(dev), init_method=f"file://{os.path.abspath(init_file)}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _worker(rank: int, world: int, device: str, init_file: str,
            timeout_s: float, inbox, outbox) -> None:
    try:
        init_world(rank, world, device, init_file, timeout_s)
    except Exception:  # the parent reads the failure and stops the pool
        outbox.put((rank, False, traceback.format_exc()))
        return
    outbox.put((rank, True, "ready"))
    try:
        while True:
            job = inbox.get()
            if job is None:
                break
            module, name, args = job
            try:
                fn = getattr(__import__(module, fromlist=[name]), name)
                outbox.put((rank, True, fn(*args)))
            except Exception:  # reported to the parent, which raises
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class SpmdError(RuntimeError):
    """A rank raised, or did not answer in time."""


class SpmdPool:
    """``world`` rank processes in one process group, spawned once and
    reused: :meth:`run` hands every rank the same function.  After a
    failure the pool is stopped and the next :meth:`run` starts a new one
    (a rank that raised can leave the others inside a collective)."""

    def __init__(self, world: int, device="cuda", init_dir: str = "",
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        if not init_dir:
            raise ValueError("init_dir holds the rendezvous files")
        self.world = world
        self.device = str(resolve_device(device))
        self.init_dir = init_dir
        self.timeout_s = timeout_s
        self._generation = 0
        self._procs: List[Any] = []
        self._inboxes: List[Any] = []
        self._outbox = None

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        self._generation += 1
        init_file = os.path.join(self.init_dir,
                                 f"rendezvous.{os.getpid()}."
                                 f"{self._generation}")
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(self.world)]
        self._procs = [ctx.Process(
            target=_worker, args=(r, self.world, self.device, init_file,
                                  self.timeout_s, self._inboxes[r],
                                  self._outbox), daemon=True)
            for r in range(self.world)]
        for p in self._procs:
            p.start()
        self._collect("start-up", 4 * self.timeout_s)

    def _collect(self, what: str, timeout_s: float) -> list:
        results: list = [None] * self.world
        errors = []
        for _ in range(self.world):
            try:
                rank, ok, value = self._outbox.get(timeout=timeout_s)
            except queue.Empty:
                self.close()
                raise SpmdError(f"{what}: a rank did not answer within "
                                f"{timeout_s:.0f} s") from None
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            self.close()
            raise SpmdError(f"{what} failed\n" + "\n".join(errors))
        return results

    def run(self, fn: Callable, *args, timeout_s: Optional[float] = None
            ) -> list:
        """Every rank runs ``fn(*args)``; the results, in rank order."""
        if not self._procs:
            self._start()
        job = (fn.__module__, fn.__qualname__, args)
        for box in self._inboxes:
            box.put(job)
        return self._collect(fn.__qualname__,
                             timeout_s or 2 * self.timeout_s)

    def close(self) -> None:
        for box in self._inboxes:
            box.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self._procs, self._inboxes, self._outbox = [], [], None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_spmd(fn: Callable, world: int, device="cuda", init_dir: str = "",
             args: tuple = (), timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """``fn(*args)`` on ``world`` fresh ranks; the results in rank
    order."""
    with SpmdPool(world, device, init_dir, timeout_s) as pool:
        return pool.run(fn, *args)
