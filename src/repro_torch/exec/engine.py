"""The pass engine: Algorithm 1's q+1 data passes over a chunk stream.

Port of ``repro/exec/engine.py``:

- :func:`pass_schedule` — q power passes, then the final pass;
- :func:`open_source` — a pass's chunk source, seeking where it can;
- :func:`run_fold` — the canonical chunk-fold loop into a
  :class:`~repro_torch.exec.accumulate.SegmentedAccumulator`, with the
  per-chunk callback that cursor checkpointing hangs off;
- :func:`fold_groups_on_mesh` — the device-parallel form of the same
  fold: whole merge groups folded one per device slot, each on its
  slot's own stream, their sums emitted in ascending group order;
  bitwise the sequential fold (the keystone of the ``Sharded`` and
  ``Hybrid`` topologies);
- :class:`StackedChunks` — random access over stacked in-memory chunks;
- :class:`PassEngine` — owns the schedule, the accumulators, the
  per-pass transitions, resume from a pass cursor, and the per-topology
  pass fold;
- :func:`fit` — the entry point over a view store for any
  :mod:`~repro_torch.exec.topology`: Local
  (:class:`~repro_torch.store.PassRunner`), Sharded (:meth:`PassEngine.run_mesh`),
  Cluster and Hybrid (:class:`~repro_torch.cluster.ClusterCoordinator`).
"""

from __future__ import annotations

import inspect
from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch

from .. import obs
from ..analysis import sanitize
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
        self.torch_dtype = torch.as_tensor(A_chunks[:0]).dtype

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
             on_chunk=None, span_attrs=None, cost_fn=None, device=None,
             pull_span: str = "io_wait") -> SegmentedAccumulator:
    """The canonical chunk-fold loop: each ``(chunk_idx, (a, b))`` left-
    folds into ``acc``'s current merge group; ``acc`` closes groups at
    the canonical boundaries.  ``on_chunk(chunk_idx, acc)`` runs after
    every fold: cursor checkpointing, in-flight bounding and failure
    injection live there, outside the fold.

    Each chunk is released before the next is pulled, so the source
    makes chunk i+1 while chunk i is already free: at Europarl width a
    chunk pair is 34 GB, and two do not fit beside the bases.

    Under ``RCCA_TRACE`` the loop records an ``io_wait`` span (named
    ``pull_span``) around each pull from the source and a ``chunk`` span
    around each fold (with
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
        with obs.device_span(pull_span, device, **base):
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


class _SlotFold:
    """:func:`run_fold`'s accumulator for one batch of the mesh fold: chunk
    ``c`` goes to the slot that folds its group, inside that slot's device
    and stream, into the slot's sink-mode accumulator, which hands the
    group's sum to ``sums`` when the group closes.  The cost model's
    numbers for the batch add up in ``cost``."""

    def __init__(self, slots, ids, init_fn_on, qs, n_chunks: int, group: int, cost_fn):
        self.slots, self.qs, self.group, self.cost_fn = slots, qs, group, cost_fn
        self.slot_of = {g: i for i, g in enumerate(ids)}
        self.sums: dict = {}
        self.accs = [SegmentedAccumulator(init_fn_on(slots.devices[i]), n_chunks, group,
                                          sink=self.sums.__setitem__) for i in range(len(ids))]
        self.cost = {"flops": 0, "bytes": 0, "entries": [], "schedule": None}

    def update(self, chunk_idx, update_fn, a, b, Qa, Qb) -> None:
        i = self.slot_of[chunk_idx // self.group]
        if self.cost_fn is not None:
            c = self.cost_fn(a, b)
            self.cost["flops"] += c["flops"]
            self.cost["bytes"] += c["bytes"]
            self.cost["entries"].extend(c["entries"])
            if self.cost["schedule"] is None:
                self.cost["schedule"] = c.get("schedule")
        with self.slots.context(i):
            self.accs[i].update(chunk_idx, update_fn, a, b, *self.qs[i])

    def flush_tail(self) -> None:
        for i, acc in enumerate(self.accs):
            with self.slots.context(i):
                acc.flush_tail()

    def close(self) -> None:
        for acc in self.accs:
            acc.close()


def fold_groups_on_mesh(access, groups: Sequence[int], update_fn, init_fn_on, Qa, Qb, *,
                        slots, merge_group: int, n_chunks: int,
                        emit: Callable[[int, object], None], dtype: torch.dtype,
                        span_attrs=None, cost_fn=None) -> list:
    """Fold whole merge groups one per device slot and emit their sums in
    ascending group order → the per-batch slot device seconds.

    ``slots`` is a :class:`~repro_torch.store.passes.SlotSet` (each slot's
    device and stream, its page-locked host buffers and look-ahead).  The
    groups go in batches of ``len(slots)``, group ``ids[i]`` of a batch to
    slot ``i``; a short batch (the last) runs on fewer slots, and the
    ragged tail group is folded on a slot like any other.  Each group is
    left-folded from ``init_fn_on(device)()`` with the Local fold's
    per-chunk ``update_fn`` on its slot, so its sum is the sequential
    fold's bits: the same updates at the same shapes, whatever runs on
    the other slots.  No collective touches a partial.

    One thread launches everything.  The batch's chunks are pulled in
    step order (chunk j of every slot's group, then chunk j + 1) through
    ONE read-ahead (:class:`~repro_torch.store.prefetch.ChunkPrefetcher`
    on a :class:`~repro_torch.store.prefetch.SlotStaging`: reads, page-
    locked host slots and each slot's device ring), and folded through
    :func:`run_fold` into a :class:`_SlotFold`, each update inside its
    slot's device and stream, so the launch counters see the Local fit's
    launches and the slots' streams run side by side.  The host waits
    once per batch, for the batch's streams, then ``emit(g, stats)``
    takes each group in order; ``emit`` may raise to abort (a worker's
    kill injection): groups already emitted stay emitted.

    ``access`` reads chunks by index (``read_chunk`` of a view store, else
    ``get_chunk``); ``n_chunks`` ends the range (a delta refit's fold stops
    there); chunks reach the update in ``dtype``.  Under ``RCCA_TRACE``
    each batch is a ``mesh_fold`` span (groups, slots, the cost model's
    flops, bytes and schedule, and on a card ``slot_device_s``: each slot
    stream's seconds for the batch) around the fold's ``gather`` (each
    pull) and ``chunk`` spans, and the call records one ``io`` counter and
    the folded chunks' ``kernel_cost`` counters.
    """
    from ..obs.cost import merge_kernel_costs

    G = int(merge_group)
    groups = sorted(int(g) for g in groups)
    D = len(slots)
    batches = [groups[lo:lo + D] for lo in range(0, len(groups), D)]
    # each batch's (slot, chunk) in pull order: step j of every group, then j + 1
    pulls = [[(i, g * G + j) for j in range(G) for i, g in enumerate(ids) if g * G + j < n_chunks]
             for ids in batches]
    order = [p for batch in pulls for p in batch]
    read = getattr(access, "read_chunk", None) or access.get_chunk
    src = slots.prefetcher((read(c) for _, c in order), [i for i, _ in order])
    qs = slots.place(Qa, Qb)
    base = dict(span_attrs or {})
    parts: list = []
    device_s: list = []
    try:
        slots.follow_current()
        for ids, batch in zip(batches, pulls):
            fold = _SlotFold(slots, ids, init_fn_on, qs, n_chunks, G, cost_fn)
            try:
                with obs.span("mesh_fold", **dict(base, groups=len(ids),
                                                  slots=[str(d) for d in slots.devices[:len(ids)]])
                              ) as sp:
                    marks = slots.mark(len(ids))
                    run_fold(((c, slots.on_slot(i, next(src), dtype)) for i, c in batch),
                             update_fn, fold, Qa, Qb, span_attrs=base or None,
                             pull_span="gather")
                    secs = slots.wait(marks)  # the batch's one host wait
                    device_s.append(secs)
                    if obs.enabled():
                        sp.attrs.update(flops=fold.cost["flops"], bytes=fold.cost["bytes"])
                        if fold.cost["schedule"] is not None:
                            sp.attrs["schedule"] = fold.cost["schedule"]
                        if secs is not None:
                            sp.attrs["slot_device_s"] = secs
                parts.extend(fold.cost["entries"])
                for g in ids:
                    emit(g, fold.sums.pop(g))
            finally:
                fold.close()
    finally:
        src.close()
        slots.io.append(src.stats())
    for part in merge_kernel_costs(parts) if parts else ():
        obs.counter("kernel_cost", **dict(base, **part))
    return device_s


class PassEngine:
    """Drive Algorithm 1's q+1 data passes under one topology.

    ``topology`` picks the pass fold: :class:`~repro_torch.exec.Local`
    folds a sequential chunk stream on ``device``; a streaming
    :class:`~repro_torch.exec.Sharded` folds whole merge groups one per
    device slot (:meth:`run_mesh`, its slots from ``device``'s kind), the
    first slot holding Q and running the boundaries — bitwise the same
    result.  Cluster and Hybrid fits are driven by
    :class:`~repro_torch.cluster.ClusterCoordinator` (:func:`fit`).

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
                 omega: str = "materialized", topology=None):
        from ..core.rcca import DEFAULT_ENGINE, resolve_engine, resolve_omega
        from .topology import Local, Sharded, as_topology

        self.cfg = cfg
        self.engine = resolve_engine(DEFAULT_ENGINE if engine is None else engine)
        self.merge_group = int(merge_group)
        self.topology = Local() if topology is None else as_topology(topology)
        self.device = resolve_device(device)
        self.slots = [self.device]
        if isinstance(self.topology, Sharded) and self.topology.col_axis is None:
            self.slots = self.topology.slots(self.device)
            self.device = self.slots[0]  # where Q lives and the passes' boundaries run
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
        torch engine).  Under ``RCCA_SANITIZE=1`` the fit opens a fresh
        sanitizer trace, observes each merge group (site ``stream``) and
        each pass's merged result (``pass_end``), and leaves the trace in
        ``diagnostics["sanitize"]`` (and in ``$RCCA_SANITIZE_OUT``).
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
        sanitize.reset()
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
                if sanitize.enabled():
                    sanitize.observe("pass_end", acc.result())
                if on_pass_complete is not None:
                    on_pass_complete(pass_idx, kind, acc, Qa, Qb)
                if kind == "power":
                    if cfg.center:  # the μ corrections need Ω itself
                        Qa, Qb = self.boundary_Q(Qa, Qb, pass_idx, da, db)
                    Qa, Qb = power_update_Q(acc.result(), Qa, Qb, cfg)
        Qa, Qb = self.boundary_Q(Qa, Qb, pass_idx, da, db)  # the q = 0 finalize
        res = finalize_result(acc.result(), Qa, Qb, cfg, da, db)
        res.diagnostics["schedules"] = schedules
        if sanitize.enabled():
            res.diagnostics["sanitize"] = sanitize.snapshot()
            sanitize.dump()
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
        sanitize.set_context(pass_idx=int(pass_idx), kind=kind, site="stream")
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

    # -- device-parallel (Sharded) -----------------------------------------

    def run_mesh(self, access, Qa=None, Qb=None, *, seed: Optional[int] = None,
                 prefetch: int = 2, on_pass_complete=None, share: int = 1):
        """All q+1 passes with merge groups folded one per device slot
        (:func:`fold_groups_on_mesh`) → ``RCCAResult``, bitwise
        :meth:`run_stream` on the same chunks.

        ``access`` needs random chunk access (a ``ViewStoreReader`` or
        :class:`StackedChunks`).  Passes restart whole (no cursors inside
        a device-parallel pass).  ``prefetch`` is each slot's read-ahead,
        ``share`` the processes folding on the same cards (the residency
        rule), ``on_pass_complete`` :meth:`run_stream`'s hook.  The
        result's ``diagnostics["topology"]`` holds the slots, groups and
        merge group and, per pass, its seconds, each batch's slot device
        seconds (on a card) and the read-ahead's IO."""
        from .topology import Sharded

        if isinstance(self.topology, Sharded) and self.topology.col_axis is not None:
            raise ValueError("streaming fits need col_axis=None: feature-sharded (col_axis) "
                             "execution is the resident-mode path through "
                             "repro_torch.core.rcca_dist.dist_randomized_cca")
        with obs.span("fit", site="mesh", engine=self.engine):
            return self._run_mesh(access, Qa, Qb, seed=seed, prefetch=prefetch,
                                  on_pass_complete=on_pass_complete, share=share)

    def _run_mesh(self, access, Qa, Qb, *, seed, prefetch, on_pass_complete, share):
        from ..core.rcca import finalize_result, power_update_Q, stats_init_fn
        from ..store.passes import SlotSet

        cfg = self.cfg
        sanitize.reset()
        da, db, nc = access.da, access.db, access.n_chunks
        n_groups = -(-nc // self.merge_group)
        slots = SlotSet(access, cfg, self.slots, prefetch=prefetch, share=share)
        passes, schedules = [], []
        try:
            Qa, Qb = self._init_payload(Qa, Qb, seed, da, db)
            for pass_idx, kind in pass_schedule(cfg.q):
                t0 = obs.monotonic()
                with obs.span("pass", pass_idx=pass_idx, kind=kind, site="mesh"):
                    acc = SegmentedAccumulator(
                        stats_init_fn(kind, da, db, cfg.sketch, self.device), nc,
                        self.merge_group)
                    device_s = self.fold_groups(access, slots, pass_idx, kind, acc, Qa, Qb,
                                                range(n_groups), n_chunks=nc,
                                                schedules=schedules)
                    if sanitize.enabled():
                        sanitize.observe("pass_end", acc.result())
                    if on_pass_complete is not None:
                        on_pass_complete(pass_idx, kind, acc, Qa, Qb)
                    if kind == "power":
                        if cfg.center:  # the μ corrections need Ω itself
                            Qa, Qb = self.boundary_Q(Qa, Qb, pass_idx, da, db)
                        Qa, Qb = power_update_Q(acc.result(), Qa, Qb, cfg)
                passes.append({"seconds": round(obs.monotonic() - t0, 4),
                               "slot_device_s": device_s, "io": slots.io[-1]})
            Qa, Qb = self.boundary_Q(Qa, Qb, pass_idx, da, db)  # the q = 0 finalize
            res = finalize_result(acc.result(), Qa, Qb, cfg, da, db)
        finally:
            slots.close()
        res.diagnostics["schedules"] = schedules
        if sanitize.enabled():
            res.diagnostics["sanitize"] = sanitize.snapshot()
            sanitize.dump()
        res.diagnostics["topology"] = {
            "name": "sharded", "slots": [str(d) for d in self.slots], "n_groups": n_groups,
            "merge_group": self.merge_group, "residency": {str(k): v for k, v in
                                                           slots.rules.items()},
            "prefetch_depth": slots.depth, "passes": passes}
        return res

    def fold_groups(self, access, slots, pass_idx: int, kind: str, acc, Qa, Qb, groups, *,
                    n_chunks: int, schedules: Optional[list] = None) -> list:
        """Fold merge groups ``groups`` of pass ``pass_idx`` over ``slots``
        (a ``store.passes.SlotSet``) into ``acc`` in ascending order, with
        the pass's update (the seeded one on a seeded pass 0): the body of
        :meth:`run_mesh`'s loop and a Sharded delta refit's range fold.
        Returns each batch's slot device seconds."""
        from ..core.rcca import seeded_update_fn, stats_init_fn, stats_like, update_fn

        kt = self.cfg.sketch
        seeded = self.seeds_in_slots and pass_idx == 0
        fn = seeded_update_fn(kind, kt) if seeded else update_fn(kind, self.engine)
        if schedules is not None:
            fn = self._recording(fn, kind, kt, seeded, schedules)
        sanitize.set_context(pass_idx=int(pass_idx), kind=kind, site="mesh")
        acc.expect(stats_like(kind, access.da, access.db, kt), self.device)
        return fold_groups_on_mesh(
            access, groups, fn, lambda dev: stats_init_fn(kind, access.da, access.db, kt, dev),
            Qa, Qb, slots=slots, merge_group=self.merge_group, n_chunks=n_chunks,
            emit=acc.push_group, dtype=self.cfg.dtype,
            span_attrs={"kind": kind, "engine": self.engine, "pass_idx": pass_idx},
            cost_fn=self.cost_fn(kind, seeded))

    # -- dispatch -----------------------------------------------------------

    def run(self, access, Qa=None, Qb=None, **kwargs):
        """All passes over a random-access chunk source (``StackedChunks``,
        a ``ViewStoreReader``) under the engine's topology."""
        from .topology import Local, Sharded

        if isinstance(self.topology, Local):
            return self.run_stream(access.iter_chunks, access.da, access.db, Qa, Qb,
                                   n_chunks=access.n_chunks, **kwargs)
        if isinstance(self.topology, Sharded):
            return self.run_mesh(access, Qa, Qb, **kwargs)
        raise ValueError(f"{type(self.topology).__name__} fits are multi-process: drive them "
                         "through repro_torch.exec.fit (it needs the store path and a "
                         "cluster directory)")


def fit(store, cfg, seed: Optional[int] = None, *, Qa=None, Qb=None, topology=None,
        engine: Optional[str] = None, merge_group: int = MERGE_GROUP_CHUNKS,
        omega: str = "materialized", prefetch=2, ckpt_dir: Optional[str] = None,
        resume: bool = False, cluster_dir: Optional[str] = None, device=DEFAULT_DEVICE,
        **cluster_kwargs):
    """Fit RandomizedCCA over a view store (a ``ViewStoreReader`` or a
    path/URI) from Ω = (Qa, Qb) or ``seed``, under any topology; every
    topology returns a bitwise-identical result on the same store.

    ``Local`` (the default) runs the prefetching, cursor-checkpointed
    :class:`~repro_torch.store.PassRunner`; ``Sharded`` the in-process
    device-parallel :meth:`PassEngine.run_mesh` over its slots (of
    ``device``'s kind); ``Cluster`` and ``Hybrid`` the multi-process
    :class:`~repro_torch.cluster.ClusterCoordinator` (``cluster_dir``
    required, further keyword arguments forwarded to it; ``prefetch`` is
    each worker's, 2 under ``"auto"``).  ``ckpt_dir`` and ``resume`` are
    the Local fit's cursors."""
    from ..core.rcca import DEFAULT_ENGINE
    from ..store import PassRunner, ViewStoreReader
    from .topology import Cluster, Hybrid, Local, Sharded, as_topology

    topo = Local() if topology is None else as_topology(topology)
    engine = DEFAULT_ENGINE if engine is None else engine
    depth = prefetch if isinstance(prefetch, int) else 2
    if not isinstance(topo, Local) and (ckpt_dir is not None or resume):
        raise ValueError("ckpt_dir and resume are the Local fit's cursors; cluster workers keep "
                         "theirs under cluster_dir, and a device-parallel pass restarts whole")
    if isinstance(topo, (Cluster, Hybrid)):
        from ..cluster import ClusterCoordinator

        if cluster_dir is None:
            raise ValueError(f"the {topo.name} topology needs cluster_dir= (the shared rounds, "
                             "partials, cursors, heartbeats and logs directory)")
        coord = ClusterCoordinator(store, cfg, cluster_dir, n_workers=topo.n_workers,
                                   devices_per_worker=topo.devices_per_worker,
                                   worker_devices=getattr(topo, "devices", None),
                                   engine=engine, merge_group=merge_group, omega=omega,
                                   prefetch=depth, device=device, **cluster_kwargs)
        return coord.fit(seed, Qa, Qb)
    if cluster_kwargs:
        raise TypeError(f"unexpected arguments for the {topo.name} topology: "
                        f"{sorted(cluster_kwargs)}")
    if isinstance(topo, Sharded):
        reader = store if isinstance(store, ViewStoreReader) else ViewStoreReader(store)
        eng = PassEngine(cfg, engine=engine, merge_group=merge_group, omega=omega,
                         device=device, topology=topo)
        return eng.run_mesh(reader, Qa, Qb, seed=seed, prefetch=depth)
    runner = PassRunner(store, cfg, engine=engine, prefetch=prefetch, ckpt_dir=ckpt_dir,
                        merge_group=merge_group, omega=omega, device=device)
    try:
        return runner.fit(Qa, Qb, seed=seed, resume=resume)
    finally:
        runner.close()
