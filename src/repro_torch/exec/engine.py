"""The pass engine: Algorithm 1's q+1 data passes over a chunk stream.

Port of ``repro/exec/engine.py`` for the Local topology:

- :func:`pass_schedule` — q power passes, then the final pass;
- :func:`open_source` — a pass's chunk source, seeking where it can;
- :func:`run_fold` — the canonical chunk-fold loop into a
  :class:`~repro_torch.exec.accumulate.SegmentedAccumulator`, with the
  per-chunk callback that cursor checkpointing hangs off;
- :class:`StackedChunks` — random access over stacked in-memory chunks;
- :class:`PassEngine` — owns the schedule, the accumulators, the
  per-pass transitions and resume from a pass cursor;
- :func:`fit` — the entry point over a view store: the Local topology
  (:class:`~repro_torch.store.PassRunner`) or the Cluster topology
  (:class:`~repro_torch.cluster.ClusterCoordinator`).

The streaming ``Sharded`` and the ``Hybrid`` topologies and the mesh
fold are not ported yet (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import inspect
from typing import Iterable, Optional, Tuple

import torch

from .. import obs
from ..device import DEFAULT_DEVICE, resolve_device
from ..obs.cost import chunk_cost_fn, merge_kernel_costs
from .accumulate import MERGE_GROUP_CHUNKS, SegmentedAccumulator


def pass_schedule(q: int) -> Iterable[Tuple[int, str]]:
    """The q+1 data passes: ``q`` range-finder ("power") passes followed
    by one "final" pass.  Yields (pass_idx, kind)."""
    for pass_idx in range(q):
        yield pass_idx, "power"
    yield q, "final"


def open_source(source_factory, start_chunk: int):
    """Instantiate one pass's chunk source → (source, index of its first
    chunk).  A factory whose first positional parameter is named ``start``
    (``PassRunner._source``, ``StackedChunks.iter_chunks``) is asked to
    begin at ``start_chunk``, so a resumed pass never reads the skipped
    prefix; any other is called with no argument and yields from chunk 0
    (the fold then skips).  Opt-in is by name, not arity."""
    try:
        params = list(inspect.signature(source_factory).parameters.values())
        seekable = bool(params) and params[0].name == "start" and params[0].kind in (
            params[0].POSITIONAL_ONLY, params[0].POSITIONAL_OR_KEYWORD)
    except (TypeError, ValueError):
        seekable = False
    if seekable:
        return source_factory(start_chunk), start_chunk
    return source_factory(), 0


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


def n_full_chunks(access) -> int:
    """Chunks of ``access`` that carry a full ``chunk`` rows: every chunk
    but a short tail."""
    if access.n % access.chunk == 0:
        return access.n_chunks
    return access.n_chunks - 1


def run_fold(indexed_chunks, update_fn, acc: SegmentedAccumulator, Qa, Qb, *,
             on_chunk=None, span_attrs=None, cost_fn=None, device=None) -> SegmentedAccumulator:
    """The canonical chunk-fold loop: each ``(chunk_idx, (a, b))`` left-
    folds into ``acc``'s current merge group; ``acc`` closes groups at
    the canonical boundaries.  ``on_chunk(chunk_idx, acc)`` runs after
    every fold: cursor checkpointing, in-flight bounding and failure
    injection live there, outside the fold.

    Each chunk is released before the next is pulled, so the source
    makes chunk i+1 while chunk i is already free: at Europarl width a
    chunk pair is 34 GB, and two do not fit beside the bases.

    Under ``RCCA_TRACE`` the loop records an ``io_wait`` span around each
    pull from the source and a ``chunk`` span around each fold (with
    ``on_chunk`` inside it), both stamped with ``span_attrs`` and timed on
    ``device``'s stream when it is a card (``obs.device_span``); a chunk
    span carries the cost model's ``flops``, ``bytes`` and ``schedule``
    when ``cost_fn(a, b)`` is given, and one ``kernel_cost`` counter per
    entry point closes the loop.  With tracing off the loop below runs
    as it always has.
    """
    if not obs.enabled():
        for chunk_idx, (a, b) in indexed_chunks:
            acc.update(chunk_idx, update_fn, a, b, Qa, Qb)
            del a, b
            if on_chunk is not None:
                on_chunk(chunk_idx, acc)
        acc.flush_tail()
        return acc

    base = dict(span_attrs or {})
    it = iter(indexed_chunks)
    kernel_parts: list = []
    while True:
        with obs.device_span("io_wait", device, **base):
            item = next(it, None)
        if item is None:
            break
        chunk_idx, (a, b) = item
        del item
        attrs = dict(base, chunk=chunk_idx)
        if cost_fn is not None:
            cost = cost_fn(a, b)
            attrs["flops"] = cost["flops"]
            attrs["bytes"] = cost["bytes"]
            if cost.get("schedule") is not None:
                attrs["schedule"] = cost["schedule"]
            kernel_parts.extend(cost["entries"])
        with obs.device_span("chunk", device, **attrs):
            acc.update(chunk_idx, update_fn, a, b, Qa, Qb)
            del a, b
            if on_chunk is not None:
                on_chunk(chunk_idx, acc)
    acc.flush_tail()
    if kernel_parts:
        for part in merge_kernel_costs(kernel_parts):
            obs.counter("kernel_cost", **dict(base, **part))
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
            return self.on_device(Qa), self.on_device(Qb)
        if seed is None:
            raise ValueError("pass Ω (Qa, Qb) or an integer seed")
        if self.seeds_in_slots:
            return omega_seeds(seed)
        return init_Q(seed, da, db, self.cfg, omega=self.omega, device=self.device)

    def boundary_Q(self, Qa, Qb, pass_idx: int, da: int, db: int):
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

    def on_device(self, x) -> torch.Tensor:
        """``x`` in ``cfg.dtype`` on the engine's device, row-major (the
        layout the data-pass kernels take)."""
        return torch.as_tensor(x, device=self.device, dtype=self.cfg.dtype).contiguous()

    def _indexed_on_device(self, source, offset: int, start_chunk: int):
        """``(chunk_idx, (a, b))`` on the device for the chunks from
        ``start_chunk`` on (``source`` yields from chunk ``offset``),
        holding no chunk while the source makes the next one
        (``enumerate`` would: it keeps its last result tuple for reuse)."""
        it = iter(source)
        chunk_idx = offset
        while (ab := next(it, None)) is not None:
            if chunk_idx < start_chunk:  # a source that cannot seek: skip
                del ab
            else:
                pair = (self.on_device(ab[0]), self.on_device(ab[1]))
                del ab
                yield chunk_idx, pair
                del pair
            chunk_idx += 1

    def run_stream(self, source_factory, da: int, db: int, Qa=None, Qb=None, *,
                   seed: Optional[int] = None, n_chunks: Optional[int] = None,
                   resume_state: Optional[dict] = None, on_pass_end=None,
                   on_pass_complete=None):
        """All q+1 passes over the chunk source → ``RCCAResult``, from Ω =
        (Qa, Qb) or from ``seed`` under the engine's omega mode.

        ``source_factory`` is called once per pass (:func:`open_source`:
        with the chunk to start from when its first parameter is named
        ``start``) and yields (a, b) chunks.

        ``resume_state`` — ``{"pass_idx", "chunk_idx", "acc", "Qa",
        "Qb"}``, a pass cursor (``store.PassRunner.restore_cursor``):
        passes before ``pass_idx`` are skipped, the pass continues at chunk
        ``chunk_idx`` from the accumulator state ``acc``
        (:meth:`SegmentedAccumulator.state`'s layout, ``current`` on the
        device) with the payload Qa/Qb it ran on (the seeds on a seeded
        pass 0); Ω and ``seed`` are then not used.
        ``on_pass_end(pass_idx, chunk_idx, acc, Qa, Qb)`` runs after every
        chunk's fold (cursor saves hang off it).
        ``on_pass_complete(pass_idx, kind, acc, Qa, Qb)`` fires once per
        pass after its fold, with the accumulator and the Qa/Qb payload
        the pass consumed.  The result's ``diagnostics["schedules"]``
        holds the schedule each pass's kernels resolved (``"staged"``,
        ``"recompute"``, ``"a/b"`` when the views differ, None under the
        torch engine).
        """
        with obs.span("fit", site="stream", engine=self.engine):
            return self._run_stream(source_factory, da, db, Qa, Qb, seed=seed,
                                    n_chunks=n_chunks, resume_state=resume_state,
                                    on_pass_end=on_pass_end,
                                    on_pass_complete=on_pass_complete)

    def _run_stream(self, source_factory, da, db, Qa, Qb, *, seed, n_chunks, resume_state,
                    on_pass_end, on_pass_complete):
        from ..core.rcca import finalize_result, power_update_Q, stats_init_fn

        cfg = self.cfg
        start_pass, start_chunk, acc_state = 0, 0, None
        if resume_state is None:
            Qa, Qb = self._init_payload(Qa, Qb, seed, da, db)
        else:
            start_pass = int(resume_state["pass_idx"])
            start_chunk = int(resume_state["chunk_idx"])
            acc_state = resume_state["acc"]
            Qa, Qb = resume_state["Qa"], resume_state["Qb"]
        schedules = []
        for pass_idx, kind in pass_schedule(cfg.q):
            if pass_idx < start_pass:
                continue
            with obs.span("pass", pass_idx=pass_idx, kind=kind, site="stream"):
                acc = SegmentedAccumulator.structure(
                    stats_init_fn(kind, da, db, cfg.sketch, self.device), n_chunks,
                    self.merge_group, start_chunk)
                if acc_state is not None:
                    acc.load_state(acc_state, self.device)
                    acc_state = None
                cb = None
                if on_pass_end is not None:
                    cb = (lambda ci, acc_, _p=pass_idx, _qa=Qa, _qb=Qb:
                          on_pass_end(_p, ci, acc_, _qa, _qb))
                self.fold_pass(source_factory, pass_idx, kind, acc, Qa, Qb,
                               start_chunk=start_chunk, on_chunk=cb, schedules=schedules)
                start_chunk = 0
                if on_pass_complete is not None:
                    on_pass_complete(pass_idx, kind, acc, Qa, Qb)
                if kind == "power":
                    if cfg.center:  # the μ corrections need Ω itself
                        Qa, Qb = self.boundary_Q(Qa, Qb, pass_idx, da, db)
                    Qa, Qb = power_update_Q(acc.result(), Qa, Qb, cfg)
        Qa, Qb = self.boundary_Q(Qa, Qb, pass_idx, da, db)  # the q = 0 finalize
        res = finalize_result(acc.result(), Qa, Qb, cfg, da, db)
        res.diagnostics["schedules"] = schedules
        return res

    def fold_pass(self, source_factory, pass_idx: int, kind: str, acc, Qa, Qb, *,
                  start_chunk: int = 0, on_chunk=None, schedules: Optional[list] = None):
        """Fold one pass's chunks from ``start_chunk`` on into ``acc`` with
        the pass's update (the seeded one on a seeded pass 0): the body of
        :meth:`run_stream`'s loop, and a delta refit's range fold.
        ``on_chunk(chunk_idx, acc)`` is :func:`run_fold`'s; the schedule
        the kernels resolve for the first chunk is appended to
        ``schedules``."""
        from ..core.rcca import seeded_update_fn, update_fn

        kt = self.cfg.sketch
        seeded = self.seeds_in_slots and pass_idx == 0
        fn = seeded_update_fn(kind, kt) if seeded else update_fn(kind, self.engine)
        if schedules is not None:
            fn = self._recording(fn, kind, kt, seeded, schedules)
        source, offset = open_source(source_factory, start_chunk)
        return run_fold(self._indexed_on_device(source, offset, start_chunk), fn, acc, Qa, Qb,
                        on_chunk=on_chunk, device=self.device,
                        span_attrs={"kind": kind, "engine": self.engine, "pass_idx": pass_idx},
                        cost_fn=self.cost_fn(kind, seeded))

    def cost_fn(self, kind: str, seeded: bool):
        """The cost model's ``(a, b) -> flops/bytes`` closure for one pass's
        chunk updates, or None when tracing is off (or under the torch
        engine, whose launches carry no cost)."""
        return chunk_cost_fn(kind, self.engine, int(self.cfg.sketch), self.cfg.dtype,
                             seeded=seeded)

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
        """All passes over a random-access chunk source (``StackedChunks``,
        a ``ViewStoreReader``)."""
        return self.run_stream(access.iter_chunks, access.da, access.db, Qa, Qb,
                               n_chunks=access.n_chunks, **kwargs)


def fit(store, cfg, seed: Optional[int] = None, *, Qa=None, Qb=None, topology=None,
        engine: Optional[str] = None, merge_group: int = MERGE_GROUP_CHUNKS,
        omega: str = "materialized", prefetch=2, ckpt_dir: Optional[str] = None,
        resume: bool = False, cluster_dir: Optional[str] = None, device=DEFAULT_DEVICE,
        **cluster_kwargs):
    """Fit RandomizedCCA over a view store (a ``ViewStoreReader`` or a
    path/URI) from Ω = (Qa, Qb) or ``seed``.

    ``Local`` (the default) runs the prefetching, cursor-checkpointed
    :class:`~repro_torch.store.PassRunner`; ``Cluster`` the multi-process
    :class:`~repro_torch.cluster.ClusterCoordinator` (``cluster_dir``
    required, further keyword arguments forwarded to it; ``prefetch`` is
    each worker's, 2 under ``"auto"``), bitwise the Local fit.  The
    streaming ``Sharded`` and the ``Hybrid`` topologies are not ported
    yet."""
    from ..core.rcca import DEFAULT_ENGINE
    from ..store import PassRunner
    from .topology import Cluster, Local, as_topology

    topo = Local() if topology is None else as_topology(topology)
    engine = DEFAULT_ENGINE if engine is None else engine
    if isinstance(topo, Cluster):
        from ..cluster import ClusterCoordinator

        if cluster_dir is None:
            raise ValueError("the cluster topology needs cluster_dir= (the shared rounds, "
                             "partials, cursors, heartbeats and logs directory)")
        if ckpt_dir is not None or resume:
            raise ValueError("ckpt_dir and resume are the Local fit's cursors; cluster workers "
                             "keep theirs under cluster_dir")
        coord = ClusterCoordinator(store, cfg, cluster_dir, n_workers=topo.n_workers,
                                   engine=engine, merge_group=merge_group, omega=omega,
                                   prefetch=prefetch if isinstance(prefetch, int) else 2,
                                   device=device, **cluster_kwargs)
        return coord.fit(seed, Qa, Qb)
    if not isinstance(topo, Local):
        raise NotImplementedError(
            f"the {topo.name} topology over a store is not ported yet (ROADMAP Queue 1 item 3: "
            "the streaming Sharded and the Hybrid topologies); use Local or Cluster")
    if cluster_kwargs:
        raise TypeError(f"unexpected arguments for the Local topology: {sorted(cluster_kwargs)}")
    runner = PassRunner(store, cfg, engine=engine, prefetch=prefetch, ckpt_dir=ckpt_dir,
                        merge_group=merge_group, omega=omega, device=device)
    try:
        return runner.fit(Qa, Qb, seed=seed, resume=resume)
    finally:
        runner.close()
