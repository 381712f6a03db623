"""The cluster protocol's recorder and its offline checker (RCCA201-204).

Port of the recording half of ``repro/analysis/protocol.py``.  The
partial store (:mod:`repro_torch.cluster.partials`) and the coordinator
emit protocol events (``stage_write``, ``commit``, ``twin_drop``,
``stale_replace``, ``read``, ``merge``, ``clean``, ``clean_fail``)
through :func:`trace_event`, which records them in the ``RCCA_TRACE``
stream as ``proto`` records (the variable reaches the worker processes
through their environment).  :func:`check_trace` then holds a recorded
sequence to the protocol's invariants (``python -m repro_torch.obs
report`` runs it over a trace's ``proto`` records):

  RCCA201  no reader observes a staging path (``*.stage<pid>`` stays
           invisible outside its writer);
  RCCA202  each (fit, pass, group) merges at most once (twice would
           count its rows twice);
  RCCA203  every read of a partial or round follows a commit of that
           path (a read with no commit means a writer bypassed the
           atomic staging and rename);
  RCCA204  a stale replacement is across bindings only (replacing a
           partial whose binding matches the writer's is a lost update).

The reference's interleaving explorer, lint, kernel checker and
determinism sanitizer are not ported (ROADMAP Queue 1 item 5), nor its
separate ``RCCA_PROTOCOL_TRACE`` file and that file's readers
(``read_trace``, ``check_trace_file``): they come with the explorer and
the command line that read them.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

from .. import obs
from .report import Violation


def trace_event(op: str, path: str = "", **meta) -> None:
    """Record one protocol event in the ``RCCA_TRACE`` stream as a
    ``proto`` record; a no-op when tracing is off."""
    if not obs.enabled():
        return
    rec = {"op": op, "path": path, "pid": os.getpid()}
    if meta:
        rec["meta"] = meta
    obs.proto_event(rec)


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
