"""Checkpoint / resume of training state for the port.

Counterpart of ``brpc_tpu/utils/checkpoint.py``, with the same API and
semantics and without orbax:

- one file per step, ``step_<n>.pt``, written by ``torch.save`` to a
  temporary name, flushed to disk and renamed into place (``os.replace``),
  so a partial write is never visible;
- any tree of dicts, lists and tuples whose leaves are tensors or Python
  scalars (params, optimizer moments, step counters) is saved from host
  copies, so the caller may go on changing its tensors;
- **placement on resume**: restoring against a target from
  :func:`abstract_like` (shape, dtype and device of every tensor) checks
  each tensor's shape and dtype and lands it on its device;
- retention: ``max_to_keep`` prunes old steps, ``latest_step()`` +
  ``restore()`` give crash-resume semantics (resume from the newest
  complete checkpoint).
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, NamedTuple, Optional

import torch

from .device import resolve_device

_NAME = re.compile(r"^step_(\d+)\.pt$")


class TensorSpec(NamedTuple):
    """What :func:`abstract_like` keeps of a tensor."""
    shape: tuple
    dtype: torch.dtype
    device: str


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


class TrainCheckpointer:
    """Save/restore a training-state tree with crash-resume semantics.

    >>> ckpt = TrainCheckpointer("/tmp/run1", max_to_keep=3)
    >>> ckpt.save(step, {"params": params, "opt": opt_state})
    >>> state = ckpt.restore(like=abstract_like(state))   # newest step
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{int(step)}.pt")

    # -- writing -----------------------------------------------------------

    def save(self, step: int, state: Any, wait: bool = True) -> bool:
        """Persist ``state`` as ``step``.  The tensors are copied to the
        host before this returns; ``wait=False`` leaves the write to disk
        in flight (async checkpointing): call :meth:`wait` (or the next
        save) before relying on it."""
        self.wait()
        host = _map(lambda x: x.detach().to("cpu", copy=True)
                    if isinstance(x, torch.Tensor) else x, state)
        if wait:
            self._write(int(step), host)
            return True
        self._pending = threading.Thread(
            target=self._write_async, args=(int(step), host), daemon=True)
        self._pending.start()
        return True

    def _write(self, step: int, host: Any) -> None:
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            torch.save(host, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        for old in self.all_steps()[:-self._max_to_keep]:
            os.remove(self._path(old))

    def _write_async(self, step: int, host: Any) -> None:
        try:
            self._write(step, host)
        except BaseException as e:  # re-raised by wait()
            self._error = e

    def wait(self) -> None:
        """Block until the write in flight is on disk; raise its error."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- reading -----------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self._dir))
                      if m)

    def restore(self, like: Any = None, step: Optional[int] = None) -> Any:
        """Restore ``step`` (default: newest).  ``like`` is a target from
        :func:`abstract_like`: each tensor is checked against its spec's
        shape and dtype and placed on its device (a CUDA device where
        CUDA is absent raises).  ``like=None`` returns the tensors on the
        CPU; pass ``like`` to resume."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self._dir}")
        state = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        return state if like is None else _place(like, state, "state")

    def close(self) -> None:
        self.wait()


def _place(like: Any, got: Any, where: str) -> Any:
    if isinstance(like, TensorSpec):
        if not isinstance(got, torch.Tensor):
            raise ValueError(f"{where}: expected a tensor, found "
                             f"{type(got).__name__}")
        if tuple(got.shape) != tuple(like.shape) or got.dtype != like.dtype:
            raise ValueError(f"{where}: saved {tuple(got.shape)} "
                             f"{got.dtype}, target {tuple(like.shape)} "
                             f"{like.dtype}")
        return got.to(resolve_device(like.device))
    if isinstance(like, dict):
        if not isinstance(got, dict) or set(got) != set(like):
            raise ValueError(f"{where}: saved keys differ from the target's")
        return {k: _place(v, got[k], f"{where}[{k!r}]")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(like):
            raise ValueError(f"{where}: saved sequence differs from the "
                             f"target's")
        return type(like)(_place(v, g, f"{where}[{i}]")
                          for i, (v, g) in enumerate(zip(like, got)))
    return got


def abstract_like(state: Any) -> Any:
    """Target mirroring ``state``'s shapes, dtypes and devices — pass to
    :meth:`TrainCheckpointer.restore` to resume in place."""
    return _map(lambda x: TensorSpec(tuple(x.shape), x.dtype, str(x.device))
                if isinstance(x, torch.Tensor) else x, state)
