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

    ``omega`` is Ω's provenance (``repro_torch.core.rcca.OMEGA_MODES``)
    when a run is given a seed.  With ``"seeded"`` and the kernels
    engine, pass 0's Qa/Qb slots carry the per-view seeds and the seeded
    update makes Ω slab by slab on the card: no (d, k̃) Ω exists during
    the pass.  The torch engine materializes the same Ω from the seeds,
    and ``"seeded-materialized"`` does so for every engine — the bitwise
    oracle of the seeded path.  Ω is made in f32 and rounded once to
    ``cfg.dtype`` in every mode (f32 or bf16), as the reference makes it.
    """

    def __init__(self, cfg, *, engine: Optional[str] = None,
                 merge_group: int = MERGE_GROUP_CHUNKS, device=DEFAULT_DEVICE,
                 omega: str = "materialized"):
        from ..core.rcca import DEFAULT_ENGINE, resolve_engine, resolve_omega

        self.cfg = cfg
        self.engine = resolve_engine(DEFAULT_ENGINE if engine is None else engine)
        self.merge_group = int(merge_group)
        self.device = resolve_device(device)
        self.omega = resolve_omega(omega)

    @property
    def seeds_in_slots(self) -> bool:
        """True when pass 0's Qa/Qb slots carry seeds, not tensors."""
        return self.omega == "seeded" and self.engine == "kernels"

    def _init_payload(self, Qa, Qb, seed: Optional[int], da: int, db: int):
        """Pass 0's Qa/Qb: the given Ω, the per-view seeds for the seeded
        kernels, or Ω made from ``seed`` under the engine's omega mode."""
        from ..core.rcca import init_Q, omega_seeds

        if Qa is not None or Qb is not None:
            if seed is not None or self.omega != "materialized":
                raise ValueError("an explicit Ω (Qa, Qb) takes omega='materialized' "
                                 "and no seed")
            return self._on_device(Qa), self._on_device(Qb)
        if seed is None:
            raise ValueError("pass Ω (Qa, Qb) or an integer seed")
        if self.seeds_in_slots:
            return omega_seeds(seed)
        return init_Q(seed, da, db, self.cfg, omega=self.omega, device=self.device)

    def _boundary_Q(self, Qa, Qb, pass_idx: int, da: int, db: int):
        """Ω as tensors at a pass boundary where the slots carry seeds and
        what follows needs the arrays (the centering correction, or the
        q = 0 finalize): one ``omega_fill`` per view.  Ya is a (d, k̃)
        tensor at every boundary already, so this stays in the memory
        class of the stats."""
        from ..kernels import rand as krand

        if not self.seeds_in_slots or pass_idx != 0:
            return Qa, Qb
        kt, dt = self.cfg.sketch, self.cfg.dtype
        return (krand.dense_omega(Qa, da, kt, dt, device=self.device),
                krand.dense_omega(Qb, db, kt, dt, device=self.device))

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

    def run_stream(self, source_factory, da: int, db: int, Qa=None, Qb=None, *,
                   seed: Optional[int] = None, n_chunks: Optional[int] = None,
                   on_pass_complete=None):
        """All q+1 passes over ``source_factory()`` (called once per pass,
        yielding (a, b) chunks) → ``RCCAResult``, from Ω = (Qa, Qb) or
        from ``seed`` under the engine's omega mode.

        ``on_pass_complete(pass_idx, kind, acc, Qa, Qb)`` fires once per
        pass after its fold, with the accumulator and the Qa/Qb payload
        the pass consumed (the seeds on a seeded pass 0).  The result's
        ``diagnostics["schedules"]`` holds the schedule each pass's
        kernels resolved (``"staged"``, ``"recompute"``, ``"a/b"`` when
        the views differ, None under the torch engine).
        """
        from ..core.rcca import (finalize_result, power_update_Q, seeded_update_fn,
                                 stats_init_fn, update_fn)

        cfg = self.cfg
        Qa, Qb = self._init_payload(Qa, Qb, seed, da, db)
        schedules = []
        for pass_idx, kind in pass_schedule(cfg.q):
            acc = SegmentedAccumulator(
                stats_init_fn(kind, da, db, cfg.sketch, self.device), n_chunks,
                self.merge_group)
            seeded = self.seeds_in_slots and pass_idx == 0
            fn = seeded_update_fn(kind, cfg.sketch) if seeded else update_fn(kind, self.engine)
            run_fold(self._indexed_on_device(source_factory()),
                     self._recording(fn, kind, cfg.sketch, seeded, schedules), acc, Qa, Qb)
            if on_pass_complete is not None:
                on_pass_complete(pass_idx, kind, acc, Qa, Qb)
            if kind == "power":
                if cfg.center:  # the μ corrections need Ω itself
                    Qa, Qb = self._boundary_Q(Qa, Qb, pass_idx, da, db)
                Qa, Qb = power_update_Q(acc.result(), Qa, Qb, cfg)
        Qa, Qb = self._boundary_Q(Qa, Qb, pass_idx, da, db)  # the q = 0 finalize
        res = finalize_result(acc.result(), Qa, Qb, cfg, da, db)
        res.diagnostics["schedules"] = schedules
        return res

    def _recording(self, fn, kind: str, kt: int, seeded: bool, schedules: list):
        """``fn``, appending to ``schedules`` the schedule the kernels
        resolve for the pass's first chunk (``ops.chunk_cost``; None for
        the torch engine)."""
        from ..kernels import ops as kops

        n_pass = len(schedules)

        def upd(s, a, b, Qa, Qb):
            if len(schedules) == n_pass:
                schedules.append(kops.chunk_cost(
                    kind, int(a.shape[0]), int(a.shape[1]), int(b.shape[1]), kt,
                    engine=self.engine, seeded=seeded, dtype=a.dtype)["schedule"])
            return fn(s, a, b, Qa, Qb)
        return upd

    def run(self, access, Qa=None, Qb=None, **kwargs):
        """All passes over a random-access chunk source (``StackedChunks``)."""
        return self.run_stream(access.iter_chunks, access.da, access.db, Qa, Qb,
                               n_chunks=access.n_chunks, **kwargs)
