"""Async chunk prefetching: overlap disk reads and host-to-device copies
with the fold.

Port of ``repro/store/prefetch.py``.  A data pass over a store is a
producer/consumer pipeline: a producer thread reads the next chunk while
the consumer folds the current one, through a queue of ``depth`` chunks.
Where the chunks land is the *staging*:

- :class:`HostStaging` (device ``cpu``): each chunk becomes CPU tensors
  of its own;
- :class:`DeviceStaging` (a card): the producer copies each chunk's rows
  (numpy views of the store's memory maps) into one of ``depth`` pairs of
  page-locked host buffers (:class:`HostSlots`, made once per owner),
  then starts a non-blocking host-to-device copy on a copy stream into a
  ring of device buffers and records an event; the consumer's stream
  waits on that event.  The ring holds two chunk pairs when the device
  look-ahead is allowed, else one (``store.passes.residency``): a chunk
  is copied into a device buffer only after the fold of the chunk that
  last used it, so a delivered chunk is valid until the next pull.  A
  host buffer is refilled only after its last copy has completed.

A mesh fold's slots each have a staging of their own (on a card: their
own host slots, copy stream and device ring, the slot's stream the
consumer), and one prefetcher feeds them all in pull order through a
:class:`SlotStaging`.

Both prefetchers meter the pipeline as the reference's do: ``read_s``
(the producer's reads: disk or page cache into memory), ``stall_s`` (the
consumer blocked on the queue), ``chunks``, ``rows`` and ``bytes``.  An
error in the producer reaches the consumer at the failing chunk; one the
consumer never reached is raised by ``close()``, which also records the
prefetcher's ``io`` trace counter (its site and those numbers).
"""

from __future__ import annotations

import queue
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..dtypes import as_tensor, bits_view, logical_name
from ..exec.accumulate import host_buffer, unlock

_SENTINEL = object()

#: Threads that copy one chunk's rows into a page-locked buffer: a copy
#: from the memory map releases the GIL, and one thread does not reach
#: the host's memory rate.
COPY_THREADS = 4


class Pair(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


class _Stopped(Exception):
    """The consumer closed the pipeline while the producer waited."""


def _host(x, dtype: Optional[str]) -> torch.Tensor:
    """A chunk view as a CPU tensor: a tensor as given, rows in the storage
    dtype (numpy) copied into one in the logical dtype ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x
    return as_tensor(np.asarray(x), dtype or logical_name(x.dtype))


class HostStaging:
    """Deliver chunks as CPU tensors (no card)."""

    def __init__(self, dtype: Optional[str] = None):
        self.dtype = dtype  # logical dtype of numpy rows (the store's)

    def stage(self, item, stop: threading.Event):
        t0 = obs.monotonic()
        staged = Pair(_host(item[0], self.dtype), _host(item[1], self.dtype))
        return staged, obs.monotonic() - t0

    def deliver(self, staged) -> Pair:
        return staged

    def release(self) -> None:
        pass

    def close(self) -> None:
        pass


def _release(pool: ThreadPoolExecutor, locked: List[torch.Tensor]) -> None:
    """:class:`HostSlots`' close and finalizer: stop the copy threads,
    unlock the buffers."""
    pool.shutdown(wait=True)
    unlock(locked)


class HostSlots:
    """Page-locked host buffers for ``rows``-row chunk pairs, made (and
    locked: ``cudaHostRegister``) once and reused by every pass of their
    owner; locking costs seconds per GB.  A slot is handed out again only
    after the last host-to-device copy out of it has completed."""

    def __init__(self, rows: int, da: int, db: int, dtype: torch.dtype):
        self.rows, self.da, self.db, self.dtype = int(rows), int(da), int(db), dtype
        self._slots: List[Pair] = []
        self._events: list = []  # the last copy out of each slot, or None
        self._locked: List[torch.Tensor] = []
        self._pool = ThreadPoolExecutor(COPY_THREADS, thread_name_prefix="chunk-copy")
        weakref.finalize(self, _release, self._pool, self._locked).atexit = False

    def __len__(self) -> int:
        return len(self._slots)

    def ensure(self, n: int) -> None:
        """At least ``n`` slots (they are never given back before close)."""
        like = (Pair, [((self.rows, self.da), self.dtype), ((self.rows, self.db), self.dtype)])
        while len(self._slots) < n:
            self._slots.append(host_buffer(like, self._locked))
            self._events.append(None)

    def take(self, i: int) -> Pair:
        """Slot ``i``, once its last copy to the card has completed."""
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        return self._slots[i]

    def mark(self, i: int, event) -> None:
        """``event`` completes the last copy out of slot ``i``."""
        self._events[i] = event

    def fill(self, dst: torch.Tensor, src) -> None:
        """Copy a chunk view (numpy rows in the storage dtype, or a tensor)
        into the first rows of slot tensor ``dst``, row blocks in
        :data:`COPY_THREADS` threads."""
        out = dst[: src.shape[0]]
        if isinstance(src, torch.Tensor):
            out.copy_(src)
            return
        out, src = bits_view(out), np.asarray(src)
        step = max(1, -(-src.shape[0] // COPY_THREADS))
        jobs = [self._pool.submit(np.copyto, out[lo:lo + step], src[lo:lo + step], casting="no")
                for lo in range(0, src.shape[0], step)]
        for j in jobs:
            j.result()

    def close(self) -> None:
        for ev in self._events:
            if ev is not None:
                ev.synchronize()
        self._slots.clear()
        self._events.clear()
        _release(self._pool, self._locked)


class DeviceStaging:
    """Deliver chunks on ``device`` (a card) through ``slots`` and a ring
    of device buffers: two chunk pairs when ``lookahead``, else one.  The
    delivered chunk is a view of a ring buffer, valid until the next
    pull; the consumer's stream (the current one when this is made) waits
    for its copy."""

    def __init__(self, device, slots: HostSlots, *, lookahead: bool):
        self.device = torch.device(device)
        self.slots = slots
        self.copy_stream = torch.cuda.Stream(self.device)
        self.compute_stream = torch.cuda.current_stream(self.device)
        n = 2 if lookahead else 1
        self._bufs: List[Optional[Pair]] = [None] * n
        self._free = [True] * n  # no delivered chunk still uses buffer j
        self._released: list = [None] * n  # the consumer's event after buffer j's last fold
        self._cv = threading.Condition()
        self._staged = 0
        self._delivered: Optional[int] = None

    def _wait_free(self, j: int, stop: threading.Event) -> None:
        with self._cv:
            while not self._free[j]:
                if stop.is_set():
                    raise _Stopped
                self._cv.wait(0.1)
            self._free[j] = False

    def _buffer(self, j: int, rows: int) -> Pair:
        """Ring buffer ``j`` with room for ``rows`` rows.  A new one comes
        from the consumer's stream, and the copy stream first waits for
        what that stream has queued (its memory may be a block freed
        there)."""
        buf = self._bufs[j]
        if buf is None or buf.a.shape[0] < rows:
            s = self.slots
            with torch.cuda.stream(self.compute_stream):
                buf = Pair(torch.empty((rows, s.da), dtype=s.dtype, device=self.device),
                           torch.empty((rows, s.db), dtype=s.dtype, device=self.device))
                ready = torch.cuda.Event()
                ready.record(self.compute_stream)
            self.copy_stream.wait_event(ready)
            self._bufs[j] = buf
        return buf

    def stage(self, item, stop: threading.Event):
        """Producer side: read the chunk into a page-locked slot, then queue
        its copy into a ring buffer → (handle, read seconds)."""
        a, b = item
        rows = int(a.shape[0])
        i = self._staged % len(self.slots)
        j = self._staged % len(self._bufs)
        slot = self.slots.take(i)
        t0 = obs.monotonic()
        self.slots.fill(slot.a, a)
        self.slots.fill(slot.b, b)
        read_s = obs.monotonic() - t0
        self._wait_free(j, stop)
        with torch.cuda.device(self.device):
            buf = self._buffer(j, rows)
            with torch.cuda.stream(self.copy_stream):
                if self._released[j] is not None:
                    self.copy_stream.wait_event(self._released[j])
                buf.a[:rows].copy_(slot.a[:rows], non_blocking=True)
                buf.b[:rows].copy_(slot.b[:rows], non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(self.copy_stream)
        self.slots.mark(i, copied)
        self._staged += 1
        return (j, rows, copied), read_s

    def deliver(self, staged) -> Pair:
        """Consumer side: the chunk, once its copy has landed (for the
        consumer's stream)."""
        j, rows, copied = staged
        self.compute_stream.wait_event(copied)
        self._delivered = j
        buf = self._bufs[j]
        return Pair(buf.a[:rows], buf.b[:rows])

    def release(self) -> None:
        """Consumer side, before the next pull: the delivered chunk's fold
        is queued, so its buffer may take a copy once that fold is done."""
        j, self._delivered = self._delivered, None
        if j is None:
            return
        done = torch.cuda.Event()
        done.record(self.compute_stream)
        with self._cv:
            self._released[j] = done
            self._free[j] = True
            self._cv.notify_all()

    def close(self) -> None:
        self.release()
        self.copy_stream.synchronize()
        self._bufs = [None] * len(self._bufs)


class SlotStaging:
    """Route a mesh fold's chunks to their device slots' stagings
    (``exec.fold_groups_on_mesh``): the k-th chunk staged goes to slot
    ``slot_ids[k]`` and is delivered in the same order; a pull releases
    the chunk delivered before it, in its own slot's staging (whose fold
    the consumer has queued by then)."""

    def __init__(self, stagings, slot_ids):
        self.stagings = list(stagings)
        self._ids = list(slot_ids)
        self._staged = 0
        self._last: Optional[int] = None

    def stage(self, item, stop: threading.Event):
        i = self._ids[self._staged]
        self._staged += 1
        handle, read_s = self.stagings[i].stage(item, stop)
        return (i, handle), read_s

    def deliver(self, staged):
        i, handle = staged
        self._last = i
        return self.stagings[i].deliver(handle)

    def release(self) -> None:
        if self._last is not None:
            self.stagings[self._last].release()
            self._last = None

    def close(self) -> None:
        for s in self.stagings:
            s.close()


def _stats(m) -> dict:
    return {"chunks": m.chunks, "rows": m.rows, "bytes": m.bytes,
            "read_s": round(m.read_s, 4), "io_stall_s": round(m.stall_s, 4)}


def _emit_io(m) -> None:
    """The ``io`` trace counter of a closing prefetcher, once: its site
    and :func:`_stats` (nothing when it read nothing)."""
    if (m.chunks or m.read_s) and not getattr(m, "_counted", False):
        m._counted = True
        obs.counter("io", site=m.site, **m.stats())


class ChunkPrefetcher:
    """Iterate ``chunks`` with a background read (and, on a card, copy)
    thread, ``depth`` chunks ahead.  Single use: ``close()`` (or running
    out) stops the thread."""

    def __init__(self, chunks: Iterable[Tuple], *, depth: int = 2, staging=None,
                 site: str = "prefetch"):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.site = site
        self._staging = staging if staging is not None else HostStaging()
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._src = iter(chunks)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._delivered = False  # the error was raised in __next__
        self.read_s = 0.0  # producer: reads into memory
        self.stall_s = 0.0  # consumer: time blocked on the queue
        self.chunks = 0
        self.rows = 0
        self.bytes = 0
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name=f"{site}-producer")
        self._thread.start()

    def _put(self, item) -> None:
        """Bounded put, polling the stop flag so ``close()`` never
        deadlocks the producer against a full queue."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _produce(self) -> None:
        try:
            while not self._stop.is_set():
                t0 = obs.monotonic()
                try:
                    item = next(self._src)  # a memory map's slice: its pages are read below
                except StopIteration:
                    break
                t_next = obs.monotonic() - t0
                staged, read_s = self._staging.stage(item, self._stop)
                self.read_s += t_next + read_s
                self.rows += int(item[0].shape[0])
                self.bytes += int(item[0].nbytes) + int(item[1].nbytes)
                del item
                self._put(staged)
            self._put(_SENTINEL)
        except _Stopped:
            return
        except BaseException as e:  # surface in the consumer
            # recorded first: if close() drains the queue before the put
            # lands, close() still raises it
            self._error = e
            self._put(e)

    def __iter__(self) -> Iterator[Pair]:
        return self

    def __next__(self) -> Pair:
        self._staging.release()
        t0 = obs.monotonic()
        item = self._q.get()
        self.stall_s += obs.monotonic() - t0
        if item is _SENTINEL:
            self._q.put(_SENTINEL)  # a further pull stops too
            raise StopIteration
        if isinstance(item, BaseException):
            self._delivered = True
            raise item
        self.chunks += 1
        return self._staging.deliver(item)

    def close(self) -> None:
        self._stop.set()
        while True:  # drain, so a blocked producer sees the flag
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=120.0)
        if self._thread.is_alive():
            raise RuntimeError(f"{self.site}: the producer thread did not stop")
        _emit_io(self)
        if self._error is not None and not self._delivered:
            self._delivered = True
            raise self._error

    def stats(self) -> dict:
        return _stats(self)


class SyncChunkMeter:
    """Prefetch off, with :class:`ChunkPrefetcher`'s metering: reads run
    inline on the consumer thread, so the stall is the read time."""

    def __init__(self, chunks: Iterable[Tuple], *, staging=None, site: str = "sync"):
        self._src = iter(chunks)
        self._staging = staging if staging is not None else HostStaging()
        self.site = site
        self.read_s = 0.0
        self.chunks = 0
        self.rows = 0
        self.bytes = 0

    @property
    def stall_s(self) -> float:
        return self.read_s  # inline reads all stall

    def __iter__(self) -> Iterator[Pair]:
        return self

    def __next__(self) -> Pair:
        self._staging.release()
        t0 = obs.monotonic()
        item = next(self._src)
        t_next = obs.monotonic() - t0
        staged, read_s = self._staging.stage(item, threading.Event())
        self.read_s += t_next + read_s
        self.chunks += 1
        self.rows += int(item[0].shape[0])
        self.bytes += int(item[0].nbytes) + int(item[1].nbytes)
        return self._staging.deliver(staged)

    def close(self) -> None:
        _emit_io(self)

    def stats(self) -> dict:
        return _stats(self)


def prefetched(chunks: Iterable[Tuple], *, depth: int = 2, staging=None,
               site: str = "prefetch"):
    """``depth == 0`` → synchronous metered reads (prefetch off); else a
    :class:`ChunkPrefetcher`.  ``staging`` says where chunks land
    (default: CPU tensors)."""
    if depth == 0:
        return SyncChunkMeter(chunks, staging=staging, site=site)
    return ChunkPrefetcher(chunks, depth=depth, staging=staging, site=site)
