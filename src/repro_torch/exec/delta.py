"""Incremental delta-refits: persist a fit's accumulator state, fold
only appended shards, re-finalize.

Port of ``repro/exec/delta.py``.  Every
accumulator field is an exact row sum, so statistics over appended rows
merge into persisted state through the same canonical pairwise tree
(:mod:`repro_torch.exec.accumulate`) that makes a resumed fit bitwise
the uninterrupted one:

- :class:`FitState` — the persisted artifact (:mod:`repro_torch.ckpt`,
  the reference's layout): pass 0's and the final pass's Qa/Qb payloads
  and accumulator state, a store snapshot (fingerprint, per-shard
  hashes) and the binding metadata (engine, omega, merge group, algo),
  so that a refit against other data or knobs fails loudly;
- :func:`fit_with_state` — a cold fit (``PassRunner.fit``, the path
  ``exec.fit`` runs for Local, or ``PassEngine.run_mesh`` for Sharded)
  that also captures that state through its ``on_pass_complete`` hook:
  bitwise ``exec.fit``'s result;
- :func:`delta_refit` — detect appended shards through the manifest
  prefix, fold only the delta, merge, re-finalize.

Two refit modes, because the power iteration couples passes to data:

``mode="exact"`` (default)
    Pass 0's Ω comes from the fit's seed alone, so the persisted pass-0
    accumulator resumes over the delta chunks and gives the whole
    corpus's pass-0 statistics bitwise.  Every later pass consumes a Q
    made from the previous pass's whole-corpus statistics, so passes
    1..q re-fold the whole store with the refreshed bases.  The result
    is bitwise the cold fit of the extended store; at q = 0 the old
    corpus is never read again.

``mode="frozen"``
    Never re-read the old corpus: fold the delta into the pass-0
    accumulator (still exact) and into the final-pass accumulator under
    the frozen final bases, then re-finalize in that basis.  Because the
    pass-0 entry stays exact, a later ``mode="exact"`` refit from the
    same state still reproduces the cold fit bitwise.

Range folds run through :meth:`repro_torch.store.PassRunner.fold`
(Local) or :meth:`repro_torch.exec.PassEngine.fold_groups` (Sharded: whole
merge groups one per device slot, the range starting on a group
boundary): the cold fit's prefetcher, update functions and schedule
rule, so every delta chunk (a ragged tail too) resolves the schedule the
cold fit gives it.  The topology shapes only how the range is folded,
never the values.

Alignment contract: the old corpus ends on a merge-group boundary
(``old_n`` divisible by ``chunk · merge_group``).  Chunk alignment keeps
every old chunk's content in the extended store; group alignment makes
the persisted pairwise stack the cold fit's mid-pass state.

The open group at a pass's end is None in the port (its successor is
made at the next chunk), and a FitState written here stores no leaves
for it; the reference writes a zero group there.  Both load, and a delta
folds onto either bitwise (:func:`_restore_acc`).

The Cluster and Hybrid topologies are rejected, as the reference
rejects them.

Under ``RCCA_TRACE`` a refit is one ``delta_refit`` span (mode, old and
new chunk counts, engine) around its range folds' ``io_wait`` and
``chunk`` spans.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..ckpt import load_flat, save_pytree
from ..device import DEFAULT_DEVICE, resolve_device
from .accumulate import MERGE_GROUP_CHUNKS, SegmentedAccumulator
from .topology import Local, Sharded, as_topology

FITSTATE_VERSION = 1

#: metadata keys that bind a FitState to its fit — a refit under any
#: other value is a different computation and must fail loudly
STATE_BINDING = ("version", "engine", "omega", "merge_group", "algo")


def _config_from_algo(algo: dict):
    """Rebuild the RCCAConfig a state was fit under from its persisted
    ``algo_meta`` dict (the inverse of ``repro_torch.core.rcca.algo_meta``)."""
    from ..core.rcca import RCCAConfig
    from ..dtypes import torch_dtype

    return RCCAConfig(
        k=int(algo["k"]), p=int(algo["p"]), q=int(algo["q"]),
        lam_a=float(algo["lam_a"]), lam_b=float(algo["lam_b"]),
        nu=None if algo["nu"] is None else float(algo["nu"]),
        center=bool(algo["center"]), dtype=torch_dtype(algo["dtype"]))


def _stats_cls(kind: str):
    from ..core.rcca import FinalStats, PowerStats

    return PowerStats if kind == "power" else FinalStats


def _local_or_sharded(topology, what: str):
    """``topology`` as a value; raise unless it is Local or Sharded (the
    reference's rule: cluster capture is a ROADMAP residual)."""
    topo = as_topology(topology)
    if not isinstance(topo, (Local, Sharded)):
        tail = "capture is a ROADMAP residual" if what == "fit_with_state" \
            else "is a ROADMAP residual"
        raise ValueError(f"{what} supports Local and Sharded topologies; {topo.name} {tail}")
    return topo


@dataclasses.dataclass
class PassCapture:
    """One persisted pass: the Qa/Qb payload it consumed (tensors, or the
    per-view seeds on a seeded pass 0) and the accumulator snapshot after
    its last chunk (``acc_current`` None between groups)."""

    kind: str
    Qa: Any
    Qb: Any
    acc_current: Any
    acc_stack: Tuple[Any, ...]

    def acc_state(self) -> Dict[str, Any]:
        return {"current": self.acc_current, "stack": self.acc_stack}


def _payload_leaf(Q):
    """A Qa/Qb slot as a leaf: the seeds of a seeded pass 0 as the
    reference's (2,)-uint32 array."""
    return np.asarray(Q, dtype=np.uint32) if isinstance(Q, tuple) else Q


def _payload(t: torch.Tensor):
    """A loaded Qa/Qb leaf as a slot: an integer leaf is a pair of seeds."""
    if t.dtype.is_floating_point:
        return t
    return tuple(int(v) for v in t.tolist())


@dataclasses.dataclass
class FitState:
    """Persisted incremental-fit state (module docstring).

    ``meta`` carries the binding and the store snapshot; ``passes`` maps
    pass index → :class:`PassCapture` for pass 0 and the final pass (the
    only two a refit consumes: intermediate power passes are recomputed
    from refreshed bases either way).
    """

    meta: Dict[str, Any]
    passes: Dict[int, PassCapture]

    def save(self, directory: str, *, zero_open_group: bool = False) -> int:
        """Write the state to ``directory`` (atomic: staged, then renamed);
        returns the bytes of its leaves.  A pass's open group, None at a
        group's close, is left out unless ``zero_open_group``: then it is
        written as the zero group the reference writes: the reference's
        loader needs it, the port's reads either layout.  It is off by
        default because the zero group costs as much disk as a closed one
        (8.6 GB for a power pass at Europarl width)."""
        tree = {}
        for p, cap in sorted(self.passes.items()):
            fields = _stats_cls(cap.kind)._fields
            current = cap.acc_current
            if current is None and zero_open_group:
                current = tuple(torch.zeros_like(t) for t in cap.acc_stack[0])
            tree[f"p{p:05d}"] = {
                "Qa": _payload_leaf(cap.Qa), "Qb": _payload_leaf(cap.Qb),
                "current": None if current is None else dict(zip(fields, current)),
                "stack": {f"{i:02d}": dict(zip(fields, s)) for i, s in enumerate(cap.acc_stack)},
            }
        meta = dict(self.meta)
        meta["pass_kinds"] = {str(p): cap.kind for p, cap in self.passes.items()}
        meta["stack_depths"] = {str(p): len(cap.acc_stack) for p, cap in self.passes.items()}
        return save_pytree(tree, directory, metadata=meta)

    @classmethod
    def load(cls, directory: str) -> "FitState":
        """The state in ``directory`` as host tensors over private memory
        maps of its files: a leaf is read when it is used (an exact refit
        never reads the final pass's Q)."""
        if not os.path.exists(os.path.join(directory, "manifest.json")):
            raise FileNotFoundError(f"no FitState at {directory!r}")
        flat, meta = load_flat(directory, mapped=True)
        if meta.get("version") != FITSTATE_VERSION:
            raise ValueError(f"unsupported FitState version {meta.get('version')}")
        passes: Dict[int, PassCapture] = {}
        for p_str, kind in meta["pass_kinds"].items():
            p = int(p_str)
            pre = f"p{p:05d}/"
            stats = _stats_cls(kind)

            def grab(at: str):
                keys = [at + f for f in stats._fields]
                if not any(k in flat for k in keys):
                    return None
                return stats(*(flat[k] for k in keys))

            depth = int(meta["stack_depths"][p_str])
            passes[p] = PassCapture(
                kind=kind, Qa=_payload(flat[pre + "Qa"]), Qb=_payload(flat[pre + "Qb"]),
                acc_current=grab(pre + "current/"),
                acc_stack=tuple(grab(f"{pre}stack/{i:02d}/") for i in range(depth)))
        return cls(meta=meta, passes=passes)


# --------------------------------------------------------------------------
# capture: a cold fit that also emits FitState
# --------------------------------------------------------------------------


def _store_snapshot(reader) -> Dict[str, Any]:
    return {
        "fingerprint": reader.fingerprint(),
        "n": int(reader.n), "chunk": int(reader.chunk),
        "da": int(reader.da), "db": int(reader.db),
        "dtype": str(reader.dtype), "n_chunks": int(reader.n_chunks),
        "shards": [[s.sha256_a, s.sha256_b] for s in reader.shards],
    }


def _reader(store):
    from ..store import ViewStoreReader

    return store if isinstance(store, ViewStoreReader) else ViewStoreReader(store)


def fit_with_state(store, cfg, seed: int, *, topology=Local(), engine: Optional[str] = None,
                   merge_group: int = MERGE_GROUP_CHUNKS, omega: str = "materialized",
                   prefetch=2, device=DEFAULT_DEVICE):
    """Cold fit over a view store from the integer ``seed`` that also
    returns the :class:`FitState` a later :func:`delta_refit` resumes
    from → ``(RCCAResult, FitState)``.

    Runs ``PassRunner.fit`` (Local) or ``PassEngine.run_mesh`` (Sharded),
    ``exec.fit``'s paths, so the result is bitwise its, with a capture on
    the ``on_pass_complete`` hook.
    """
    from ..core.rcca import DEFAULT_ENGINE, algo_meta
    from ..store import PassRunner
    from .engine import PassEngine

    dev = resolve_device(device)
    topo = _local_or_sharded(topology, "fit_with_state")
    reader = _reader(store)
    engine = DEFAULT_ENGINE if engine is None else engine
    captured: Dict[int, PassCapture] = {}

    def capture(pass_idx, kind, acc, Qa, Qb):
        if pass_idx in (0, cfg.q):
            st = acc.state()
            captured[pass_idx] = PassCapture(kind=kind, Qa=Qa, Qb=Qb,
                                             acc_current=st["current"],
                                             acc_stack=tuple(st["stack"]))

    if isinstance(topo, Sharded):
        eng = PassEngine(cfg, engine=engine, merge_group=merge_group, omega=omega, device=dev,
                         topology=topo)
        res = eng.run_mesh(reader, seed=seed, prefetch=prefetch if isinstance(prefetch, int)
                           else 2, on_pass_complete=capture)
    else:
        eng = PassRunner(reader, cfg, engine=engine, prefetch=prefetch, merge_group=merge_group,
                         omega=omega, device=dev)
        try:
            res = eng.fit(seed=seed, on_pass_complete=capture)
        finally:
            eng.close()
    meta = {
        "version": FITSTATE_VERSION,
        "engine": eng.engine, "omega": eng.omega,
        "merge_group": int(merge_group), "algo": algo_meta(cfg),
        **_store_snapshot(reader),
    }
    return res, FitState(meta=meta, passes=captured)


# --------------------------------------------------------------------------
# delta detection + refit
# --------------------------------------------------------------------------


def delta_chunks(state: FitState, reader) -> Tuple[int, int]:
    """Validate that ``reader`` extends the state's store snapshot and
    return ``(old_n_chunks, new_n_chunks)``.

    The old store must be an exact prefix of the new one: same geometry,
    the old shard hash list leading the new shard list unchanged, and the
    old row count aligned to a merge-group boundary.  ``old == new`` (no
    delta) is valid and returns equal counts.
    """
    m = state.meta
    for field in ("da", "db", "chunk", "dtype"):
        got = str(getattr(reader, field)) if field == "dtype" else int(getattr(reader, field))
        want = m[field] if field == "dtype" else int(m[field])
        if got != want:
            raise ValueError(
                f"store geometry changed: {field} was {want!r}, now {got!r} — not an append")
    old_shards = [tuple(s) for s in m["shards"]]
    new_shards = [(s.sha256_a, s.sha256_b) for s in reader.shards]
    if len(new_shards) < len(old_shards) or new_shards[:len(old_shards)] != old_shards:
        raise ValueError(
            "store is not an append of the fitted snapshot: the old shard list is not a "
            "hash-identical prefix of the new manifest (rewritten or reordered shards cannot "
            "delta-refit)")
    old_n, chunk = int(m["n"]), int(m["chunk"])
    if reader.n < old_n:
        raise ValueError(f"store shrank: {old_n} rows fitted, {reader.n} now")
    group_rows = chunk * int(m["merge_group"])
    if reader.n > old_n and old_n % group_rows:
        raise ValueError(
            f"delta refit needs the fitted corpus to end on a merge-group boundary: {old_n} "
            f"rows is not a multiple of chunk × merge_group = {group_rows} (append at group "
            "granularity, or cold-fit)")
    # ceil: a ragged old corpus is only reachable in the no-delta case
    return -(-old_n // chunk), reader.n_chunks


def _restore_acc(cap: PassCapture, init_fn, old_nc: int, new_nc: int, merge_group: int,
                 device: torch.device) -> SegmentedAccumulator:
    """The persisted accumulator as the cold fit's mid-pass state at
    chunk ``old_nc`` of a ``new_nc``-chunk corpus.  At a group boundary a
    zero open group (the reference's layout) is the successor the next
    chunk makes from zero, so it is dropped; anything else there is not a
    state this fit could have left."""
    acc = SegmentedAccumulator.structure(init_fn, new_nc, merge_group, old_nc)
    current = cap.acc_current
    if current is not None:
        if acc.open_chunks == 0:
            if any(bool(t.any()) for t in current):
                raise ValueError("FitState has a non-zero open group at a merge-group boundary")
            current = None
        else:
            current = type(current)(*(t.to(device) for t in current))
    acc.load_state({"current": current, "stack": cap.acc_stack}, device)
    return acc


def delta_refit(state: FitState, store, *, mode: str = "exact", topology=Local(),
                prefetch=2, device=DEFAULT_DEVICE):
    """Refit against an extended store by folding only what changed →
    ``(RCCAResult, FitState)``: the refreshed result and the state to
    persist for the next refit.  ``mode`` picks the exact-vs-frozen trade
    (module docstring); ``topology`` (Local or Sharded) only how the
    ranges are folded, never the values.  With no appended rows, re-finalizes from the
    state without reading the store.  ``diagnostics["delta"]`` holds the
    mode, the delta and refolded chunk counts, the seconds taken to
    restore pass 0's accumulator (``restore_s``: its closed groups copied
    into the merge stack's host buffers) and each fold's IO (``passes``:
    seconds, rows and bytes read)."""
    from ..core.rcca import finalize_result, power_update_Q, stats_init_fn
    from ..store import PassRunner

    from .engine import PassEngine

    dev = resolve_device(device)
    if mode not in ("exact", "frozen"):
        raise ValueError(f"unknown mode {mode!r}; expected exact or frozen")
    topo = _local_or_sharded(topology, "delta_refit")
    reader = _reader(store)
    m = state.meta
    cfg = _config_from_algo(m["algo"])
    q, kt = cfg.q, cfg.sketch
    old_nc, new_nc = delta_chunks(state, reader)
    if isinstance(topo, Sharded):
        from ..store.passes import SlotSet

        eng = PassEngine(cfg, engine=m["engine"], merge_group=int(m["merge_group"]),
                         omega=m["omega"], device=dev, topology=topo)
        dev = eng.device
        runner = SlotSet(reader, cfg, eng.slots, prefetch=prefetch if isinstance(prefetch, int)
                         else 2)

        def fold(pass_idx, kind, acc, Qa, Qb, start=0):
            # ``start`` is a merge-group boundary: the alignment contract
            eng.fold_groups(reader, runner, pass_idx, kind, acc, Qa, Qb,
                            range(start // G, -(-new_nc // G)), n_chunks=new_nc)

        def io_passes():
            return list(runner.io)
    else:
        runner = PassRunner(reader, cfg, engine=m["engine"], prefetch=prefetch,
                            merge_group=int(m["merge_group"]), omega=m["omega"], device=dev)
        eng = runner.pass_engine()
        fold, io_passes = runner.fold, runner.io_passes
    da, db = reader.da, reader.db
    G = eng.merge_group

    def slots(cap):
        if isinstance(cap.Qa, tuple):
            return cap.Qa, cap.Qb
        return eng.on_device(cap.Qa), eng.on_device(cap.Qb)

    def restore(cap):
        return _restore_acc(cap, stats_init_fn(cap.kind, da, db, kt, dev), old_nc, new_nc, G,
                            dev)

    def capture(kind, acc, Qa, Qb):
        st = acc.state()
        return PassCapture(kind=kind, Qa=Qa, Qb=Qb, acc_current=st["current"],
                           acc_stack=tuple(st["stack"]))

    cap0, capF = state.passes[0], state.passes[q]
    new_meta = {**{k: m[k] for k in STATE_BINDING}, **_store_snapshot(reader)}
    delta = new_nc - old_nc
    with obs.span("delta_refit", mode=mode, old_chunks=old_nc, new_chunks=new_nc,
                  engine=eng.engine):
        try:
            if delta == 0:  # nothing appended: re-finalize only
                accF = restore(capF)
                res = finalize_result(accF.result(), *eng.boundary_Q(*slots(capF), q, da, db), cfg,
                                      da, db)
                res.diagnostics["delta"] = {"mode": mode, "delta_chunks": 0}
                return res, state

            # pass 0 over the delta only — exact for both modes: Ω comes from
            # the seed, not the data
            Qa0, Qb0 = slots(cap0)
            t0 = obs.monotonic()
            acc0 = restore(cap0)
            restore_s = obs.monotonic() - t0
            fold(0, cap0.kind, acc0, Qa0, Qb0, start=old_nc)
            new_cap0 = capture(cap0.kind, acc0, Qa0, Qb0)

            if mode == "frozen" and q > 0:
                # the delta into the final accumulator under the frozen bases
                QaF, QbF = slots(capF)
                accF = restore(capF)
                fold(q, capF.kind, accF, QaF, QbF, start=old_nc)
                res = finalize_result(accF.result(), QaF, QbF, cfg, da, db)
                res.diagnostics["delta"] = {"mode": mode, "delta_chunks": delta,
                                            "refolded_chunks": delta, "restore_s": restore_s,
                                            "passes": io_passes()}
                return res, FitState(meta=new_meta,
                                     passes={0: new_cap0, q: capture(capF.kind, accF, QaF, QbF)})

            # exact mode (and q = 0, where frozen degenerates to exact): rotate
            # Q from the whole corpus's pass-0 stats, then re-fold the whole
            # store for passes 1..q — exactly the cold fit's loop
            refolded = delta
            if q == 0:
                res = finalize_result(acc0.result(), *eng.boundary_Q(Qa0, Qb0, 0, da, db), cfg,
                                      da, db)
                res.diagnostics["delta"] = {"mode": "exact", "delta_chunks": delta,
                                            "refolded_chunks": refolded, "restore_s": restore_s,
                                            "passes": io_passes()}
                return res, FitState(meta=new_meta, passes={0: new_cap0})

            Qa, Qb = Qa0, Qb0
            if cfg.center:  # the μ corrections need the actual Ω
                Qa, Qb = eng.boundary_Q(Qa, Qb, 0, da, db)
            Qa, Qb = power_update_Q(acc0.result(), Qa, Qb, cfg)
            acc = None
            for pass_idx in range(1, q + 1):
                kind = "power" if pass_idx < q else "final"
                acc = SegmentedAccumulator(stats_init_fn(kind, da, db, kt, dev), new_nc, G)
                fold(pass_idx, kind, acc, Qa, Qb)
                refolded += new_nc
                if kind == "power":
                    Qa, Qb = power_update_Q(acc.result(), Qa, Qb, cfg)
            res = finalize_result(acc.result(), Qa, Qb, cfg, da, db)
            res.diagnostics["delta"] = {"mode": "exact", "delta_chunks": delta,
                                        "refolded_chunks": refolded, "restore_s": restore_s,
                                        "passes": io_passes()}
            return res, FitState(meta=new_meta,
                                 passes={0: new_cap0, q: capture("final", acc, Qa, Qb)})
        finally:
            runner.close()
