"""Canonical pass accumulation: chunk → merge group → pairwise tree.

Port of ``repro/exec/accumulate.py``.  Chunks left-fold into fixed-size
MERGE GROUPS; group sums reduce through a fixed PAIRWISE TREE whose
shape is a function of the group index alone.  The reduction order is
therefore fixed, and so are the result's bits on one device.

A "stats" value is a ``NamedTuple`` of tensors whose merge is
elementwise addition (``PowerStats`` / ``FinalStats`` of
:mod:`repro_torch.core.rcca`).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

#: Chunks per merge group — the granularity of the canonical reduction.
MERGE_GROUP_CHUNKS = 8

Stats = Any


def merge_stats(x: Stats, y: Stats) -> Stats:
    """Combine two accumulators over disjoint row sets: elementwise
    addition of every field."""
    return type(x)(*(u + v for u, v in zip(x, y)))


class PairwiseStack:
    """Binary-counter pairwise summation: pushing partial ``m`` merges
    stack tops of equal weight, so the reduction tree depends on the
    partial's index alone.  Live memory is O(log #groups) stats."""

    def __init__(self):
        self.stack: List[Stats] = []
        self.counts: List[int] = []

    def push(self, s: Stats) -> None:
        self.stack.append(s)
        self.counts.append(1)
        while len(self.counts) >= 2 and self.counts[-1] == self.counts[-2]:
            hi = self.stack.pop()
            self.stack[-1] = merge_stats(self.stack[-1], hi)
            self.counts[-1] += self.counts.pop()

    def result(self) -> Optional[Stats]:
        """Fold the leftover unequal-weight entries newest → oldest."""
        if not self.stack:
            return None
        res = self.stack[-1]
        for s in reversed(self.stack[:-1]):
            res = merge_stats(s, res)
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

    def update(self, chunk_idx: int, update_fn: Callable[..., Stats],
               a: Any, b: Any, Qa: Any, Qb: Any) -> None:
        """Fold one chunk, closing the merge group at its boundary."""
        if self.current is None:
            self.current = self.init_fn()
        self.current = update_fn(self.current, a, b, Qa, Qb)
        self.end_chunk(chunk_idx)

    def end_chunk(self, chunk_idx: int) -> None:
        self._in_group += 1
        nxt = chunk_idx + 1
        if nxt % self.group_chunks == 0 or nxt == self.n_chunks:
            self._push_current()

    def flush_tail(self) -> None:
        """Close a ragged tail group at end of stream (for sources of
        unknown length; a known ``n_chunks`` closes it in end_chunk)."""
        if self._in_group:
            self._push_current()

    def _push_current(self) -> None:
        self._tree.push(self.current)
        self.current = None
        self.groups_done += 1
        self._in_group = 0

    def result(self) -> Stats:
        r = self._tree.result()
        return self.init_fn() if r is None else r
