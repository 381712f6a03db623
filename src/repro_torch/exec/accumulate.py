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

The group-level entry points serve the topologies whose merge groups are
folded elsewhere (a cluster worker's partials): an accumulator with a
``sink`` hands each closed group to it instead of the tree;
:meth:`SegmentedAccumulator.push_group_span` feeds a group sum, or an
aligned dyadic span of them, into the tree in group order;
:class:`SpanCombiner` pre-merges a worker's runs of groups into such
spans; :func:`reduce_group_partials` reduces an in-memory set.
"""

from __future__ import annotations

import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, List, Mapping, Optional

import torch

from .. import obs
from ..analysis import sanitize

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
    """A stack's close and finalizer: stop its worker, unlock its buffers.

    Nothing is queued on the worker by then (a queued merge holds the
    stack, so a stack being collected has none; :meth:`PairwiseStack.close`
    waits for its own first), so the worker is not joined: a finalizer run
    by the garbage collector inside another thread's start-up would
    deadlock on the join."""
    worker.shutdown(wait=False)
    unlock(locked)


def _check_span(count: int) -> None:
    if count < 1 or count & (count - 1):
        raise ValueError(f"span weight must be a power of two, got {count}")


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
        self._finalizer = weakref.finalize(self, _close, self._worker, self._locked)
        self._finalizer.atexit = False

    def close(self) -> None:
        """Wait for the pending merges, stop the worker thread and unlock
        the buffers (the entries are then no longer page-locked); safe to
        call more than once."""
        try:
            self._wait()
        finally:
            self._finalizer()

    def expect(self, s: Stats, device=None) -> None:
        """Announce partials shaped like ``s`` (the open group, or a like-tree
        of ``meta`` tensors whose partials come from ``device``): the first
        push's host buffer is then made while the card works."""
        if self._like is None:
            self.device = s[0].device if device is None else torch.device(device)
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
        self.push_span(s, 1, more)

    def push_span(self, s: Stats, count: int, more: bool = True) -> None:
        """Add ``s``, the canonical pairwise sum of ``count`` consecutive
        partials (a power of two), as one entry of weight ``count``.  When
        the span is aligned (it starts at a multiple of ``count``) it is one
        subtree of the binary-counter reduction, so this merges exactly as
        its ``count`` partials pushed one by one would; alignment is the
        caller's contract (:meth:`SegmentedAccumulator.push_group_span`
        checks it)."""
        _check_span(count)
        if s[0].device.type == "cuda":
            torch.cuda.synchronize(s[0].device)
        t0 = obs.monotonic()
        self.expect(s)
        self._wait()
        self._ensure_spare()
        buf = self._spare.pop()
        for b, t in zip(buf, s):
            b.copy_(t)
        self.stack.append(buf)
        self.counts.append(count)
        if more:
            self._pending = self._worker.submit(self._merge, True)
        else:
            self._merge(False)
        self.host_seconds += obs.monotonic() - t0

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
    plus the ragged tail) enters a :class:`PairwiseStack` or, when a
    ``sink`` is given, is handed to ``sink(group index, stats)`` (a
    cluster worker's publish path; the stack then stays empty).

    A closed group's successor is made only when the next chunk arrives,
    not at the close: at Europarl width one zero PowerStats is 8.6 GB,
    and after the last group none is needed.

    Under ``RCCA_SANITIZE=1`` every group sum that enters the tree is
    fingerprinted (:func:`repro_torch.analysis.sanitize.observe`):
    ``group:g`` as it closes or arrives, ``span:gxN`` for a combined span
    of N groups.  A sink-mode accumulator hands its groups on unobserved
    (the sink's owner observes what it publishes).
    """

    def __init__(self, init_fn: Callable[[], Stats], n_chunks: Optional[int],
                 group_chunks: int = MERGE_GROUP_CHUNKS,
                 sink: Optional[Callable[[int, Stats], None]] = None):
        if group_chunks <= 0:
            raise ValueError("merge group size must be positive")
        self.init_fn = init_fn
        self.n_chunks = None if n_chunks is None else int(n_chunks)
        self.group_chunks = int(group_chunks)
        self.sink = sink
        self.current: Optional[Stats] = None
        self._tree = PairwiseStack()
        self.groups_done = 0
        self._in_group = 0  # chunks folded into ``current`` so far
        self._last_chunk = -1  # global index of the last folded chunk

    @property
    def n_groups(self) -> int:
        return -(-self.n_chunks // self.group_chunks)

    @property
    def open_chunks(self) -> int:
        """Chunks folded into the open group (0 at a group boundary)."""
        return self._in_group

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
            if self.sink is None:
                self._tree.expect(self.current)
        self.current = update_fn(self.current, a, b, Qa, Qb)
        self.end_chunk(chunk_idx)

    def end_chunk(self, chunk_idx: int) -> None:
        self._in_group += 1
        self._last_chunk = chunk_idx
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
        g = self._last_chunk // self.group_chunks
        if self.sink is not None:
            self.sink(g, self.current)
        else:
            if sanitize.enabled():  # a merge group enters the tree: the contract's unit
                sanitize.observe(f"group:{g}", self.current)
            self._tree.push(self.current, more)
        self.current = None
        self.groups_done += 1
        self._in_group = 0

    def expect(self, like: Stats, device) -> None:
        """Announce group sums shaped like ``like`` (e.g. ``rcca.stats_like``)
        from ``device`` before any chunk is folded here (a mesh fold's
        groups come from its slots): the stack's first host buffer is made
        while the card works, as at a sequential fold's first chunk."""
        if self.sink is None:
            self._tree.expect(like, device)

    def resume_group(self, current: Stats, next_chunk: int) -> None:
        """Continue an open group from a cursor (a sink-mode worker's):
        ``current`` holds its chunks before ``next_chunk``."""
        self.current = current
        self._in_group = next_chunk % self.group_chunks
        self._last_chunk = next_chunk - 1

    def push_group(self, group_idx: int, stats: Stats) -> None:
        """Feed a merge group's sum computed elsewhere (a cluster partial),
        in ascending group order with no gaps."""
        self.push_group_span(group_idx, stats, 1)

    def push_group_span(self, group_idx: int, stats: Stats, span: int) -> None:
        """Feed the pairwise sum of ``span`` consecutive merge groups from
        ``group_idx`` (a worker-combined partial).  ``span`` is a power of
        two and the span aligned (``group_idx % span == 0``), so it is one
        subtree of the canonical reduction and merges bitwise as its groups
        pushed one by one; spans arrive in ascending group order with no
        gaps.  The entry is copied into the stack's host buffers."""
        if group_idx != self.groups_done:
            raise ValueError(f"merge groups must arrive in order: got {group_idx}, "
                             f"expected {self.groups_done}")
        _check_span(span)
        if group_idx % span:
            raise ValueError(f"span of {span} groups at {group_idx} is unaligned — not a "
                             "subtree of the canonical reduction")
        if self.n_chunks is not None and group_idx + span > self.n_groups:
            raise ValueError(f"span [{group_idx}, {group_idx + span}) overruns the "
                             f"{self.n_groups}-group pass")
        more = self.n_chunks is None or group_idx + span < self.n_groups
        if sanitize.enabled():
            sanitize.observe(f"group:{group_idx}" if span == 1 else f"span:{group_idx}x{span}",
                             stats)
        self._tree.push_span(stats, span, more)
        self.groups_done += span

    def close(self) -> None:
        """Close the stack (:meth:`PairwiseStack.close`)."""
        self._tree.close()

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


class SpanCombiner:
    """Combiner on the way out of a cluster worker: pre-merge its runs of
    consecutive merge groups into aligned dyadic spans before publishing.

    ``emit(g, stats)`` takes the worker's closed groups in order; a run
    starting at a multiple of ``span`` is pushed through a local
    :class:`PairwiseStack` and leaves as ``sink(g0, count, merged)`` once
    ``span`` groups are in, or when the run breaks (the worker jumped to
    its next run, or :meth:`flush` at the end of its stream).  The local
    stack is the canonical binary-counter reduction, so each entry it
    leaves is one subtree of the coordinator's tree: an aligned run of 5
    groups leaves as spans of 4 + 1, bitwise the 5 groups merged
    downstream.  A group that starts a run unaligned (a repair worker's
    group list) passes through as a span of 1.  The local stack merges in
    host memory; :meth:`close` releases it.
    """

    def __init__(self, span: int, sink: Callable[[int, int, Stats], None]):
        if span < 1 or span & (span - 1):
            raise ValueError(f"combine span must be a power of two, got {span}")
        self.span = int(span)
        self.sink = sink
        self._g0: Optional[int] = None  # run start (aligned)
        self._count = 0
        self._tree: Optional[PairwiseStack] = None

    def emit(self, g: int, stats: Stats) -> None:
        if self._g0 is not None and g != self._g0 + self._count:
            self.flush()  # the run broke: the worker jumped to its next run
        if self._g0 is None:
            if self.span == 1 or g % self.span:
                self.sink(g, 1, stats)  # an unaligned start: no combining
                return
            self._g0 = g
            self._tree = PairwiseStack()
        self._count += 1
        self._tree.push(stats, more=self._count < self.span)
        if self._count == self.span:
            self.flush()

    def flush(self) -> None:
        """Publish what is buffered: after ``count`` pushes the local
        stack's entries mirror count's binary digits, each an aligned
        dyadic block (the run starts at a multiple of ``span``)."""
        if self._g0 is None:
            return
        tree, g = self._tree, self._g0
        self._g0, self._count, self._tree = None, 0, None
        try:
            entries = tree.snapshot()
            for entry, weight in zip(entries, tree.counts):
                self.sink(g, weight, entry)
                g += weight
        finally:
            tree.close()

    def close(self) -> None:
        """Drop a run that was never flushed (an error path)."""
        if self._tree is not None:
            self._tree.close()
        self._g0, self._count, self._tree = None, 0, None


def reduce_group_partials(partials: Mapping[int, Stats], init_fn: Callable[[], Stats],
                          n_chunks: int, group_chunks: int = MERGE_GROUP_CHUNKS) -> Stats:
    """The canonical tree over an in-memory set of per-group partials
    (group index → stats, every group present): bitwise the single-process
    accumulation whichever worker made which group and in what order they
    came.  The cluster coordinator streams the same tree from disk."""
    acc = SegmentedAccumulator(init_fn, n_chunks, group_chunks)
    try:
        for g in range(acc.n_groups):
            if g not in partials:
                raise ValueError(f"merge group {g} missing from partial set")
            acc.push_group(g, partials[g])
        return acc.result()
    finally:
        acc.close()
