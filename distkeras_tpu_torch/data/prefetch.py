"""Background batch prefetching and the host -> device feed.

The port's counterpart of ``distkeras_tpu/data/prefetch.py`` (without
its ``obs`` spans and counters, which come with the observability
port):

- :class:`Prefetcher` runs a batch iterator (shuffle-gather, windows,
  dtype conversion) on a daemon thread, ``depth`` items ahead of the
  training loop, so batch preparation overlaps the device step;
- :class:`DeviceFeed` keeps ``depth`` host -> device copies in flight
  from the consuming thread: each batch goes through pinned memory with
  ``.to(device, non_blocking=True)``, so the next batch's bytes move
  while the card works on the current one.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from distkeras_tpu_torch.utils.device import resolve_device


def _map(fn, item):
    """``fn`` over the arrays of a (nested) tuple / list / dict batch."""
    if isinstance(item, (tuple, list)):
        return type(item)(_map(fn, x) for x in item)
    if isinstance(item, dict):
        return {k: _map(fn, v) for k, v in item.items()}
    return fn(item)


class DeviceFeed:
    """Stream host batches (numpy arrays or tensors, or tuples / lists /
    dicts of them) to ``device``, ``depth`` items in flight.

    Copies are issued from the consuming thread on the current stream,
    so a yielded batch is ready for any work the consumer queues after
    it.  On the card each batch is staged in pinned host memory, and the
    pinned tensors stay referenced here until their copy has finished
    (a pinned buffer freed early could be reused, and overwritten, while
    the copy still reads it).  ``device`` defaults to the card;
    ``device="cpu"`` passes the batches through as tensors.
    """

    def __init__(self, source: Iterable, depth: int = 2, device=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._source = source
        self._depth = depth
        self._device = resolve_device(device)

    def _host(self, a):
        t = torch.as_tensor(np.ascontiguousarray(a)) \
            if isinstance(a, np.ndarray) else torch.as_tensor(a)
        return t.pin_memory() if self._device.type == "cuda" else t

    def __iter__(self):
        cuda = self._device.type == "cuda"
        pending: collections.deque = collections.deque()
        copying: collections.deque = collections.deque()  # (host, event)

        def issue(item):
            host = _map(self._host, item)
            dev = _map(lambda t: t.to(self._device, non_blocking=True), host)
            if cuda:
                event = torch.cuda.Event()
                event.record()
                copying.append((host, event))
            return dev

        def retire():
            while copying and copying[0][1].query():
                copying.popleft()

        try:
            for item in self._source:
                pending.append(issue(item))
                if len(pending) > self._depth:
                    retire()
                    yield pending.popleft()
            while pending:
                retire()
                yield pending.popleft()
        finally:
            for _, event in copying:
                event.synchronize()


class Prefetcher:
    """Iterate ``source`` on a background thread, ``depth`` items ahead.

    Exceptions in the source re-raise in the consumer (once; the
    iterator is exhausted afterwards, like a generator).  Abandoning the
    iterator mid-stream is safe: ``close()`` — called by ``__del__`` and
    usable explicitly — unblocks and stops the producer thread.
    """

    _DONE = object()

    def __init__(self, source: Iterable, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._finished = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(iter(source),),
            name="dkt-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Enqueue unless closed; False means stop producing."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it: Iterator) -> None:
        try:
            for item in it:
                if not self._put(item):
                    return
        except BaseException as e:  # passed on to the consumer
            self._err = e
        finally:
            self._put(self._DONE)

    def close(self) -> None:
        """Stop the producer and release buffered items.

        Also wakes a consumer already blocked in ``__next__`` (the drain
        below could otherwise swallow the producer's ``_DONE`` sentinel
        and leave that consumer blocked forever).
        """
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._finished = True
        try:
            self._q.put_nowait(self._DONE)
        except queue.Full:
            pass  # a queued item will wake the consumer instead

    def __del__(self):  # pragma: no cover - GC timing
        if hasattr(self, "_stop"):  # not when __init__ raised
            self.close()

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        while True:
            try:
                item = self._q.get(timeout=0.05)
                break
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration from None
        if item is self._DONE:
            self._finished = True
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item
