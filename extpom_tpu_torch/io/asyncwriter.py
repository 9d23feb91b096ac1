"""Asynchronous output and restart writer (``extpom_tpu/io/asyncwriter.py``).

The reference stalls every rank inside its collective writes at each print
and restart interval (io_pnetcdf.F:57-410, 1661-2083).  Here the writes
run on a worker thread while the next segment computes.

Torch tensors are mutable and the caching allocator reuses freed device
memory, so the worker never reads a device tensor: :meth:`AsyncWriter.submit`
first takes a host copy of every tensor its arguments hold (a non-blocking
copy into pinned memory, queued on the current stream ahead of the next
segment's kernels, and one CUDA event the worker waits on before it
writes).  CPU tensors are cloned.

* at most ``max_pending`` writes queue before ``submit`` blocks;
* a failed write raises on the next ``submit``/``flush``/``close``;
* ``busy_s`` sums the worker's time in the writes (the wait for the copy
  included) and ``blocked_s`` the caller's time in ``submit`` (the copies
  queued) and ``flush``/``close``: what the writer hid is the difference.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import types
from typing import Callable, Optional

import torch


def _host_copy(obj, pending: list):
    """``obj`` with every tensor it holds (directly, in a dataclass, a
    SimpleNamespace, a dict, a list or a tuple) replaced by a host copy;
    CUDA copies are non-blocking and listed in ``pending``."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cpu":
            return obj.detach().clone()
        out = torch.empty(obj.shape, dtype=obj.dtype, pin_memory=True)
        out.copy_(obj.detach(), non_blocking=True)
        pending.append(obj.device)
        return out
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _host_copy(getattr(obj, f.name), pending)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, types.SimpleNamespace):
        return types.SimpleNamespace(**{k: _host_copy(v, pending)
                                        for k, v in vars(obj).items()})
    if isinstance(obj, dict):
        return {k: _host_copy(v, pending) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v, pending) for v in obj)
    return obj


class AsyncWriter:
    def __init__(self, max_pending: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._err: Optional[BaseException] = None
        self.busy_s = 0.0
        self.blocked_s = 0.0
        self.n_writes = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="extpom-io-writer")
        self._thread.start()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            fn, args, kw, event = item
            t0 = time.perf_counter()
            try:
                if event is not None:
                    event.synchronize()
                fn(*args, **kw)
            except Exception as e:          # raised on the next call
                self._err = e
            finally:
                self.busy_s += time.perf_counter() - t0
                self.n_writes += 1
                self._q.task_done()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async output write failed") from err

    def submit(self, fn: Callable, *args, **kw) -> None:
        """Queue ``fn(*args, **kw)`` on host copies of the arguments'
        tensors; blocks only while ``max_pending`` writes are queued."""
        self._raise_pending()
        t0 = time.perf_counter()
        pending: list = []
        args, kw = _host_copy((args, kw), pending)
        event = None
        if pending:                  # the worker waits for the copies
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(pending[0]))
        self._q.put((fn, args, kw, event))
        self.blocked_s += time.perf_counter() - t0

    def flush(self) -> None:
        """Wait for the queued writes; raise any failure."""
        t0 = time.perf_counter()
        self._q.join()
        self.blocked_s += time.perf_counter() - t0
        self._raise_pending()

    def close(self) -> None:
        self.flush()
        self._q.put(None)
        self._thread.join()
