"""Cluster-protocol race detector (RCCA2xx), port of
``repro/analysis/protocol.py``.

Two halves:

1. **Recording and offline invariant checking.**  The partial store
   (:mod:`repro_torch.cluster.partials`) and the coordinator emit
   protocol events (``stage_write``, ``commit``, ``twin_drop``,
   ``stale_replace``, ``read``, ``merge``, ``clean``, ``clean_fail``)
   through :func:`trace_event`: one JSON line a event, appended with one
   ``O_APPEND`` write to the file ``$RCCA_PROTOCOL_TRACE`` names, and
   mirrored into the ``RCCA_TRACE`` stream as a ``proto`` record (both
   variables reach the worker processes through their environment).
   :func:`check_trace` holds a recorded sequence to the invariants
   (``python -m repro_torch.obs report`` runs it over a trace's ``proto``
   records, :func:`check_trace_file` over the protocol file):

     RCCA201  no reader observes a staging path (``*.stage<pid>`` stays
              invisible outside its writer);
     RCCA202  each (fit, pass, group) merges at most once (twice would
              count its rows twice);
     RCCA203  every read of a partial or round follows a commit of that
              path (a read with no commit means a writer bypassed the
              atomic staging and rename);
     RCCA204  a stale replacement is across bindings only (replacing a
              partial whose binding matches the writer's is a lost
              update).

2. **Small-model interleaving exploration.**  :func:`explore_interleavings`
   checks the publish/crash protocol exhaustively for 2 workers and at
   most 4 merge groups: every interleaving of the workers' publishes,
   for the fault-free run and for every crash point, the crashed
   worker's unpublished groups re-dispatched; for each ordering the
   coordinator's streamed merge (the port's
   :class:`~repro_torch.exec.accumulate.SegmentedAccumulator` on CPU
   tensors) must equal :func:`~repro_torch.exec.accumulate.reduce_group_partials`
   bit for bit, on float32 payloads whose sum depends on the order.
   ``mutate`` injects protocol bugs (a merge in arrival order, a torn
   publish) so tests can show that the explorer catches them.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

from .. import obs
from .report import Violation

TRACE_ENV = "RCCA_PROTOCOL_TRACE"


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------


def trace_event(op: str, path: str = "", **meta) -> None:
    """Record one protocol event: one JSON line appended to the file
    ``$RCCA_PROTOCOL_TRACE`` names (one ``os.write`` with ``O_APPEND``,
    so concurrent workers interleave whole lines), and a ``proto`` record
    in the ``RCCA_TRACE`` stream.  A no-op when neither is set."""
    out = os.environ.get(TRACE_ENV)
    if not out and not obs.enabled():
        return
    rec = {"op": op, "path": path, "pid": os.getpid()}
    if meta:
        rec["meta"] = meta
    obs.proto_event(rec)
    if not out:
        return
    line = json.dumps(rec, sort_keys=True, default=str) + "\n"
    fd = os.open(out, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, line.encode())
    finally:
        os.close(fd)


def read_trace(path: str) -> List[dict]:
    """The events of a protocol trace file, in file order."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


# ---------------------------------------------------------------------------
# offline invariant checking
# ---------------------------------------------------------------------------


def check_trace(events: Sequence[dict], *, where: str = "trace") -> List[Violation]:
    """RCCA201-204 over a recorded event sequence (its order is the
    serialization seen on the shared file system)."""
    out: List[Violation] = []
    committed = set()
    merged: Dict[tuple, int] = {}
    for i, ev in enumerate(events):
        op = ev.get("op", "?")
        path = ev.get("path", "")
        meta = ev.get("meta", {})
        loc = f"{where}#{i}"
        if op == "commit":
            committed.add(path)
        elif op == "read":
            if ".stage" in os.path.basename(path):
                out.append(Violation(
                    "RCCA201", loc, i,
                    f"reader observed staging path {path!r} — staged tmp "
                    "must be invisible until the atomic rename"))
            elif path not in committed:
                out.append(Violation(
                    "RCCA203", loc, i,
                    f"read of {path!r} with no prior commit — a writer "
                    "bypassed the atomic staging+rename publish"))
        elif op == "merge":
            key = (meta.get("fit_id"), meta.get("pass_idx"), meta.get("group"))
            if key in merged:
                out.append(Violation(
                    "RCCA202", loc, i,
                    f"merge group {key[2]} of pass {key[1]} entered the "
                    f"tree twice (first at event {merged[key]}) — "
                    "double-counted data"))
            else:
                merged[key] = i
        elif op == "stale_replace":
            if meta.get("old_binding") == meta.get("new_binding"):
                out.append(Violation(
                    "RCCA204", loc, i,
                    f"stale replacement of {path!r} with an IDENTICAL "
                    "binding — that is a lost-update race, not staleness"))
    return out


def check_trace_file(path: Optional[str] = None) -> List[Violation]:
    """RCCA201-204 over a protocol trace file (default
    ``$RCCA_PROTOCOL_TRACE``); a missing file is clean."""
    path = path or os.environ.get(TRACE_ENV)
    if not path or not os.path.exists(path):
        return []
    return check_trace(read_trace(path), where=path)


# ---------------------------------------------------------------------------
# small-model interleaving exploration
# ---------------------------------------------------------------------------


@dataclass
class ExplorationReport:
    n_groups: int
    n_workers: int
    n_scenarios: int = 0
    n_interleavings: int = 0
    mismatches: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.mismatches

    def violations(self) -> List[Violation]:
        return [Violation("RCCA205", "model", 0, m) for m in self.mismatches]


class Payload(NamedTuple):
    """The model's merge-group stats: four float32 sums and a row count
    (CPU tensors)."""

    y: Any
    n: Any


def _interleavings(seqs: List[List[int]]):
    """Every merge of the (order-preserving) per-worker sequences."""
    seqs = [s for s in seqs if s]
    if not seqs:
        yield []
        return
    for i in range(len(seqs)):
        head, rest = seqs[i][0], [list(s) for s in seqs]
        rest[i] = rest[i][1:]
        for tail in _interleavings(rest):
            yield [head] + tail


def _group_payload(g: int) -> Payload:
    """Order-sensitive float32 stats for group ``g``: summands of very
    different magnitudes, so any departure from the canonical reduction
    order changes the result's bits.  [1e8, -1e8, 3, 4]: pairing
    (1e8 + -1e8) keeps the small terms (the canonical tree gives 7), while
    (1e8 + 3) absorbs them (another pairing gives 0)."""
    import numpy as np
    import torch

    magnitude = (1e8, -1e8, 3.0, 4.0)[g % 4]
    y = np.asarray([magnitude, 1.0 + g, 1e8 * ((-1) ** g), 0.1 * (g + 1)], dtype=np.float32)
    return Payload(torch.from_numpy(y), torch.tensor(float(g + 1), dtype=torch.float32))


def explore_interleavings(n_workers: int = 2, n_groups: int = 4, *,
                          mutate: Optional[str] = None) -> ExplorationReport:
    """Exhaustive small-model check of the publish/crash/merge protocol.

    Model: ``n_groups`` merge groups strided over ``n_workers`` workers
    (worker ``w`` owns the groups ``g ≡ w (mod n_workers)``, the cluster's
    assignment at combine span 1), each publishing its groups in
    ascending order.  Scenarios: the fault-free run and every single
    crash (either worker, after any prefix of its publishes), the dead
    worker's unpublished groups re-dispatched to a repair worker.  For
    each scenario and each interleaving of the publish sequences, the
    coordinator's merge is replayed as the streamed group-order
    :class:`~repro_torch.exec.accumulate.SegmentedAccumulator` and
    compared bit for bit with
    :func:`~repro_torch.exec.accumulate.reduce_group_partials`.  At the
    defaults: 5 scenarios, 42 interleavings.

    ``mutate`` injects a protocol bug: ``"arrival_order"``, the
    coordinator merges in publish order instead of group order;
    ``"torn_publish"``, the crashed worker's next publish lands half
    written and is not re-dispatched.
    """
    import torch

    from ..exec.accumulate import SegmentedAccumulator, reduce_group_partials

    if n_groups > 4 or n_workers != 2:
        raise ValueError("small-model explorer: 2 workers, ≤4 groups")

    def init_fn():
        return Payload(torch.zeros(4, dtype=torch.float32), torch.tensor(0.0))

    n_chunks = n_groups  # one chunk a group: the tree's geometry
    canonical = reduce_group_partials({g: _group_payload(g) for g in range(n_groups)},
                                      init_fn, n_chunks, group_chunks=1)
    owners = {w: [g for g in range(n_groups) if g % n_workers == w] for w in range(n_workers)}
    report = ExplorationReport(n_groups=n_groups, n_workers=n_workers)

    # a scenario: (the crashed worker or None, its publishes before the crash)
    scenarios = [(None, 0)] + [(w, k) for w in range(n_workers) for k in range(len(owners[w]))]
    for crashed, k in scenarios:
        report.n_scenarios += 1
        pub: Dict[int, List[int]] = {w: list(owners[w]) for w in range(n_workers)}
        redispatch: List[int] = []
        torn: Optional[int] = None
        if crashed is not None:
            alive, lost = pub[crashed][:k], pub[crashed][k:]
            if mutate == "torn_publish" and lost:
                # the crash tears the next publish: it lands half written on
                # disk and nobody re-dispatches it
                torn = lost[0]
                alive, lost = alive + [torn], lost[1:]
            pub[crashed] = alive
            redispatch = lost
        # the repair worker publishes the re-dispatched groups in order
        seqs = [pub[w] for w in range(n_workers)] + ([redispatch] if redispatch else [])
        for order in _interleavings([list(s) for s in seqs]):
            report.n_interleavings += 1
            disk = {}
            for g in order:  # publishes serialize, the last write wins
                payload = _group_payload(g)
                if g == torn:
                    y = payload.y.clone()
                    y[2:] = 0.0  # a half-written partial
                    payload = Payload(y, payload.n)
                disk[g] = payload
            merge_order = (sorted(disk) if mutate != "arrival_order"
                           else list(dict.fromkeys(order)))
            acc = SegmentedAccumulator(init_fn, n_chunks, group_chunks=1)
            try:
                for pos, g in enumerate(merge_order):
                    # the model replays the coordinator's merge (a buggy one
                    # under "arrival_order": fed by arrival position)
                    acc.push_group(pos if mutate == "arrival_order" else g, disk[g])  # rcca: noqa[RCCA001] — the model checker replays the coordinator's merge by design
                got = acc.result()
            except ValueError as e:
                report.mismatches.append(f"scenario crash={crashed}@{k} order={order}: "
                                         f"merge rejected: {e}")
                continue
            finally:
                acc.close()
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(got, canonical)):
                report.mismatches.append(f"scenario crash={crashed}@{k} order={order}: merged "
                                         "result differs bitwise from the canonical pairwise "
                                         "tree")
    return report
