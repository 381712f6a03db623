"""The pass engine: Algorithm 1's q+1 data passes over a chunk stream.

Port of ``repro/exec/engine.py`` for the Local topology:

- :func:`pass_schedule` — q power passes, then the final pass;
- :func:`run_fold` — the canonical chunk-fold loop into a
  :class:`~repro_torch.exec.accumulate.SegmentedAccumulator`;
- :class:`StackedChunks` — random access over stacked in-memory chunks;
- :class:`PassEngine` — owns the schedule, the accumulators and the
  per-pass transitions.

Resume state, the other topologies and the mesh fold are not ported yet.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .accumulate import MERGE_GROUP_CHUNKS, SegmentedAccumulator


def pass_schedule(q: int) -> Iterable[Tuple[int, str]]:
    """The q+1 data passes: ``q`` range-finder ("power") passes followed
    by one "final" pass.  Yields (pass_idx, kind)."""
    for pass_idx in range(q):
        yield pass_idx, "power"
    yield q, "final"


class StackedChunks:
    """Random-access adapter over stacked chunk arrays ``(nc, c, d)``."""

    def __init__(self, A_chunks, B_chunks):
        if A_chunks.shape[0] != B_chunks.shape[0] or A_chunks.shape[1] != B_chunks.shape[1]:
            raise ValueError(f"paired chunk stacks required, got "
                             f"{tuple(A_chunks.shape)} / {tuple(B_chunks.shape)}")
        self.A, self.B = A_chunks, B_chunks
        self.n_chunks = int(A_chunks.shape[0])
        self.chunk = int(A_chunks.shape[1])
        self.n = self.n_chunks * self.chunk
        self.da = int(A_chunks.shape[2])
        self.db = int(B_chunks.shape[2])

    def get_chunk(self, i: int):
        return self.A[i], self.B[i]

    def iter_chunks(self, start: int = 0):
        for i in range(start, self.n_chunks):
            yield self.get_chunk(i)


def run_fold(indexed_chunks, update_fn, acc: SegmentedAccumulator, Qa, Qb
             ) -> SegmentedAccumulator:
    """The canonical chunk-fold loop: each ``(chunk_idx, (a, b))`` left-
    folds into ``acc``'s current merge group; ``acc`` closes groups at
    the canonical boundaries.

    Each chunk is released before the next is pulled, so the source
    makes chunk i+1 while chunk i is already free: at Europarl width a
    chunk pair is 34 GB, and two do not fit beside the bases.
    """
    for chunk_idx, (a, b) in indexed_chunks:
        acc.update(chunk_idx, update_fn, a, b, Qa, Qb)
        del a, b
    acc.flush_tail()
    return acc


class PassEngine:
    """Drive Algorithm 1's q+1 data passes on one device.

    ``engine`` picks the per-chunk update: ``"kernels"`` (the CUDA
    kernels; their plain versions for CPU tensors) or ``"torch"`` (the
    plain oracle).  Chunks from the source are taken in ``cfg.dtype`` on
    ``device`` (a tensor already there in that dtype is used as it is).
    """

    def __init__(self, cfg, *, engine: Optional[str] = None,
                 merge_group: int = MERGE_GROUP_CHUNKS, device=DEFAULT_DEVICE):
        from ..core.rcca import DEFAULT_ENGINE, resolve_engine

        self.cfg = cfg
        self.engine = resolve_engine(DEFAULT_ENGINE if engine is None else engine)
        self.merge_group = int(merge_group)
        self.device = resolve_device(device)

    def _on_device(self, x) -> torch.Tensor:
        """``x`` in ``cfg.dtype`` on the engine's device, row-major (the
        layout the data-pass kernels take)."""
        return torch.as_tensor(x, device=self.device, dtype=self.cfg.dtype).contiguous()

    def _indexed_on_device(self, source):
        """``(chunk_idx, (a, b))`` on the device, holding no chunk while
        the source makes the next one (``enumerate`` would: it keeps its
        last result tuple for reuse)."""
        it = iter(source)
        chunk_idx = 0
        while (ab := next(it, None)) is not None:
            pair = (self._on_device(ab[0]), self._on_device(ab[1]))
            del ab
            yield chunk_idx, pair
            del pair
            chunk_idx += 1

    def run_stream(self, source_factory, da: int, db: int, Qa, Qb, *,
                   n_chunks: Optional[int] = None, on_pass_complete=None):
        """All q+1 passes over ``source_factory()`` (called once per pass,
        yielding (a, b) chunks) from Ω = (Qa, Qb) → ``RCCAResult``.

        ``on_pass_complete(pass_idx, kind, acc, Qa, Qb)`` fires once per
        pass after its fold, with the accumulator and the bases the pass
        consumed.
        """
        from ..core.rcca import finalize_result, power_update_Q, stats_init_fn, update_fn

        cfg = self.cfg
        Qa, Qb = self._on_device(Qa), self._on_device(Qb)
        for pass_idx, kind in pass_schedule(cfg.q):
            acc = SegmentedAccumulator(
                stats_init_fn(kind, da, db, cfg.sketch, self.device), n_chunks,
                self.merge_group)
            run_fold(self._indexed_on_device(source_factory()), update_fn(kind, self.engine),
                     acc, Qa, Qb)
            if on_pass_complete is not None:
                on_pass_complete(pass_idx, kind, acc, Qa, Qb)
            if kind == "power":
                Qa, Qb = power_update_Q(acc.result(), Qa, Qb, cfg)
        return finalize_result(acc.result(), Qa, Qb, cfg, da, db)

    def run(self, access, Qa, Qb, **kwargs):
        """All passes over a random-access chunk source (``StackedChunks``)."""
        return self.run_stream(access.iter_chunks, access.da, access.db, Qa, Qb,
                               n_chunks=access.n_chunks, **kwargs)
