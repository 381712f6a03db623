"""Canonical pass accumulation: chunk → merge group → pairwise tree.

Port of ``repro/exec/accumulate.py``.  Chunks left-fold into fixed-size
MERGE GROUPS; group sums reduce through a fixed PAIRWISE TREE whose
shape is a function of the group index alone.  The reduction order is
therefore fixed, and so are the result's bits on one device.

A "stats" value is a ``NamedTuple`` of tensors whose merge is
elementwise addition (``PowerStats`` / ``FinalStats`` of
:mod:`repro_torch.core.rcca`).

Closed merge groups live in host memory.  At Europarl width one
PowerStats is 8.6 GB: kept on the card, the stack's log2(#groups)
closed groups, the group in progress, Q and the 34 GB chunk pair
outgrow its 80 GB by the 15th of the corpus's 19 groups.  On the host
the card holds only the open group, whatever the chunk count.  The
price is one device-to-host copy per closed group, into host buffers
page-locked in place (``cudaHostRegister``), so the copy runs at DMA
rate; PyTorch's pinned allocator would round each 4.3 GB field up to
8 GB.  Locking a new 8.6 GB buffer and adding two on the host take
seconds each, so both run on a worker thread while the card computes
the next chunks.
"""

from __future__ import annotations

import time
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, List, Optional

import torch

#: Chunks per merge group — the granularity of the canonical reduction.
MERGE_GROUP_CHUNKS = 8

#: ``cudaHostRegisterPortable``: locked for every CUDA context, whichever
#: thread registers it.
_REGISTER_PORTABLE = 1

Stats = Any


def merge_stats(x: Stats, y: Stats) -> Stats:
    """Combine two accumulators over disjoint row sets: elementwise
    addition of every field."""
    return type(x)(*(u + v for u, v in zip(x, y)))


def _cuda_check(err, what: str) -> None:
    cudart = torch.cuda.cudart()
    if err != cudart.cudaError.success:
        raise RuntimeError(f"{what}: {cudart.cudaGetErrorString(err)}")


def host_buffer(like, locked: Optional[List[torch.Tensor]] = None) -> Stats:
    """Empty host tensors for a stats value described by ``like`` =
    (type, [(shape, dtype), ...]).  With ``locked`` given, each tensor is
    page-locked and appended to ``locked``, whose owner must unlock it
    (:func:`unlock`) before the tensor is freed."""
    kind, fields = like
    out = kind(*(torch.empty(shape, dtype=dtype) for shape, dtype in fields))
    if locked is not None:
        for h in out:
            if h.numel():
                _cuda_check(torch.cuda.cudart().cudaHostRegister(
                    h.data_ptr(), h.numel() * h.element_size(), _REGISTER_PORTABLE),
                    "cudaHostRegister")
                locked.append(h)
    return out


def unlock(locked: List[torch.Tensor]) -> None:
    """Unlock the host buffers :func:`host_buffer` locked into ``locked``."""
    for t in locked:
        _cuda_check(torch.cuda.cudart().cudaHostUnregister(t.data_ptr()), "cudaHostUnregister")
    locked.clear()


def _close(worker: ThreadPoolExecutor, locked: List[torch.Tensor]) -> None:
    """A stack's finalizer: let its worker finish, then unlock its buffers."""
    worker.shutdown(wait=True)
    unlock(locked)


class PairwiseStack:
    """Binary-counter pairwise summation: pushing partial ``m`` merges
    stack tops of equal weight, so the reduction tree depends on the
    partial's index alone.  Live memory is O(log #groups) stats, all of
    it in host memory.

    A pushed partial is copied into a host buffer the stack owns and
    merges there, in place into the older entry.  The tree's shape, its
    order of additions and the dtype are the all-device tree's, and f32
    addition is correctly rounded on the host as on the card, so the
    bits are too.  :meth:`result` returns the sum on the device the
    partials came from.

    The copy runs in :meth:`push`; the merges it makes due, and the
    buffer the next push will need, are made on the stack's worker
    thread, which the next push waits for.  After the last push
    (``more=False``) the merges run in the push itself.  Buffers of
    merged-away entries take the next copies; from the card, every
    buffer is page-locked while the stack lives.  ``host_seconds`` is
    the time the caller spends in the stack after the device has
    finished the work queued before each push: copies, and the merges
    and allocations it waits for.
    """

    def __init__(self):
        self.stack: List[Stats] = []
        self.counts: List[int] = []
        self.device: Optional[torch.device] = None
        self.host_seconds = 0.0
        self._like = None  # (type, [(shape, dtype)]) of the partials
        self._lock = False  # page-lock the buffers (partials from the card)
        self._spare: List[Stats] = []  # host buffers ready for the next copy
        self._locked: List[torch.Tensor] = []
        self._worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="merge-stack")
        self._pending: Optional[Future] = None
        weakref.finalize(self, _close, self._worker, self._locked).atexit = False

    def expect(self, s: Stats) -> None:
        """Announce partials shaped like ``s`` (the open group): the first
        push's host buffer is then made while the card works."""
        if self._like is None:
            self.device = s[0].device
            self._like = (type(s), [(t.shape, t.dtype) for t in s])
            self._lock = self.device.type == "cuda"
            self._pending = self._worker.submit(self._ensure_spare)

    def _ensure_spare(self) -> None:
        if not self._spare:
            self._spare.append(host_buffer(self._like, self._locked if self._lock else None))

    @staticmethod
    def counts_after(m: int) -> List[int]:
        """Entry weights after ``m`` pushes: m's binary digits, highest first."""
        return [1 << i for i in reversed(range(m.bit_length())) if m >> i & 1]

    def snapshot(self) -> tuple:
        """The entries once the pending merges are done (host tensors the
        stack owns; a later push may merge into them)."""
        self._wait()
        return tuple(self.stack)

    def load(self, entries, counts: List[int], device: torch.device) -> None:
        """Take ``entries`` (host tensors, e.g. a checkpoint's) as the
        stack of weights ``counts``: each is copied into a buffer the stack
        owns, page-locked when the partials come from the card."""
        self._wait()
        self.device = device
        self._lock = device.type == "cuda"
        self.stack, self.counts = [], list(counts)
        for e in entries:
            if self._like is None:
                self._like = (type(e), [(t.shape, t.dtype) for t in e])
            buf = host_buffer(self._like, self._locked if self._lock else None)
            for b, t in zip(buf, e):
                b.copy_(t)
            self.stack.append(buf)

    def _wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()  # re-raises the worker's exception

    def _merge(self, more: bool) -> None:
        while len(self.counts) >= 2 and self.counts[-1] == self.counts[-2]:
            hi = self.stack.pop()
            for u, v in zip(self.stack[-1], hi):
                u.add_(v)  # older + newer, as merge_stats(older, newer)
            self._spare.append(hi)
            self.counts[-1] += self.counts.pop()
        if more:
            self._ensure_spare()

    def push(self, s: Stats, more: bool = True) -> None:
        """Add partial ``s``; ``more=False`` says it is the last one."""
        if s[0].device.type == "cuda":
            torch.cuda.synchronize(s[0].device)
        t0 = time.perf_counter()
        self.expect(s)
        self._wait()
        self._ensure_spare()
        buf = self._spare.pop()
        for b, t in zip(buf, s):
            b.copy_(t)
        self.stack.append(buf)
        self.counts.append(1)
        if more:
            self._pending = self._worker.submit(self._merge, True)
        else:
            self._merge(False)
        self.host_seconds += time.perf_counter() - t0

    def result(self) -> Optional[Stats]:
        """Fold the leftover unequal-weight entries newest → oldest on the
        partials' device (once per pass, when the card holds no chunk)."""
        self._wait()
        if not self.stack:
            return None

        def back(s):
            return type(s)(*(t.to(self.device) for t in s))
        res = back(self.stack[-1])
        for s in reversed(self.stack[:-1]):
            res = merge_stats(back(s), res)
        return res


class SegmentedAccumulator:
    """Canonical accumulation of one data pass: chunks left-fold into the
    current group; each completed group (every ``group_chunks`` chunks,
    plus the ragged tail) enters a :class:`PairwiseStack`.

    A closed group's successor is made only when the next chunk arrives,
    not at the close: at Europarl width one zero PowerStats is 8.6 GB,
    and after the last group none is needed.
    """

    def __init__(self, init_fn: Callable[[], Stats], n_chunks: Optional[int],
                 group_chunks: int = MERGE_GROUP_CHUNKS):
        if group_chunks <= 0:
            raise ValueError("merge group size must be positive")
        self.init_fn = init_fn
        self.n_chunks = None if n_chunks is None else int(n_chunks)
        self.group_chunks = int(group_chunks)
        self.current: Optional[Stats] = None
        self._tree = PairwiseStack()
        self.groups_done = 0
        self._in_group = 0  # chunks folded into ``current`` so far

    @staticmethod
    def groups_completed(next_chunk: int, n_chunks: Optional[int], group_chunks: int) -> int:
        """Merge groups fully folded once chunks [0, next_chunk) are in;
        with a known length the ragged tail group completes with the last
        chunk."""
        if n_chunks is not None and next_chunk >= n_chunks:
            return -(-n_chunks // group_chunks)
        return next_chunk // group_chunks

    def update(self, chunk_idx: int, update_fn: Callable[..., Stats],
               a: Any, b: Any, Qa: Any, Qb: Any) -> None:
        """Fold one chunk, closing the merge group at its boundary."""
        if self.current is None:
            self.current = self.init_fn()
            self._tree.expect(self.current)
        self.current = update_fn(self.current, a, b, Qa, Qb)
        self.end_chunk(chunk_idx)

    def end_chunk(self, chunk_idx: int) -> None:
        self._in_group += 1
        nxt = chunk_idx + 1
        if nxt == self.n_chunks:
            self._push_current(more=False)
        elif nxt % self.group_chunks == 0:
            self._push_current(more=True)

    def flush_tail(self) -> None:
        """Close a ragged tail group at end of stream (for sources of
        unknown length; a known ``n_chunks`` closes it in end_chunk)."""
        if self._in_group:
            self._push_current(more=False)

    def _push_current(self, more: bool) -> None:
        self._tree.push(self.current, more)
        self.current = None
        self.groups_done += 1
        self._in_group = 0

    @property
    def host_seconds(self) -> float:
        """Seconds the fold spent in the merge stack (copies to the host,
        waits for its merges and buffers)."""
        return self._tree.host_seconds

    def result(self) -> Stats:
        r = self._tree.result()
        return self.init_fn() if r is None else r

    # -- checkpointing ----------------------------------------------------

    def state(self) -> dict:
        """Checkpointable snapshot: ``"current"``, the open group's stats
        on the device, or None between groups (its successor is made at
        the next chunk); ``"stack"``, the closed entries, host tensors the
        stack owns, once its pending merges are done.  Nothing is copied:
        write the snapshot out before folding on."""
        return {"current": self.current, "stack": self._tree.snapshot()}

    def load_state(self, state, device=None) -> None:
        """Continue from ``state`` (:meth:`state`'s layout, e.g. restored
        host tensors): ``current`` is taken as given (place it on the
        device first), the stack entries are copied into buffers the
        stack owns — page-locked when ``device`` is a card — and their
        weights follow from ``groups_done``, as :meth:`structure` set it."""
        current, stack = state["current"], tuple(state["stack"])
        if (current is None) != (self._in_group == 0):
            raise ValueError(f"accumulator state {'lacks' if current is None else 'has'} an "
                             f"open group, but {self._in_group} chunks of one are folded")
        counts = PairwiseStack.counts_after(self.groups_done)
        if len(counts) != len(stack):
            raise ValueError(f"accumulator state has {len(stack)} stack entries; "
                             f"{self.groups_done} completed groups imply {len(counts)}")
        if device is None:
            device = current[0].device if current is not None else torch.device("cpu")
        self._tree.load(stack, counts, torch.device(device))
        self.current = current

    @classmethod
    def structure(cls, init_fn: Callable[[], Stats], n_chunks: Optional[int],
                  group_chunks: int, next_chunk: int,
                  like: Optional[Stats] = None) -> "SegmentedAccumulator":
        """The accumulator at a resume position (chunks [0, next_chunk)
        folded), for :meth:`load_state`.  Given ``like`` (a stats value,
        e.g. ``rcca.stats_like``), its :meth:`state` is the like-tree of a
        restore, every entry a ``meta`` tensor: shapes and dtypes, no
        memory (at Europarl width an entry is 8.6 GB)."""
        acc = cls(init_fn, n_chunks, group_chunks)
        acc.groups_done = cls.groups_completed(next_chunk, n_chunks, group_chunks)
        acc._in_group = max(0, next_chunk - acc.groups_done * group_chunks)
        if like is not None:
            meta = type(like)(*(torch.empty(t.shape, dtype=t.dtype, device="meta")
                                for t in like))
            acc.current = meta if acc._in_group else None
            acc._tree.counts = PairwiseStack.counts_after(acc.groups_done)
            acc._tree.stack = [meta] * len(acc._tree.counts)
        return acc
