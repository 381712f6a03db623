"""Export an ``RCCA_TRACE`` directory as Chrome trace-event JSON.

    python -m repro_torch.obs export-trace rcca_trace -o trace.json

Port of ``repro/obs/chrometrace.py``, record for record.  The output
loads in ``chrome://tracing`` or Perfetto (https://ui.perfetto.dev) and
shows what ``repro_torch.obs report`` sums on a timeline: one track per
process and thread, nested spans as complete ("X") events, counters as
counter ("C") tracks, cluster-protocol events as instants ("i").

======================  =============================================
obs record              trace-event record
======================  =============================================
``ev: span``            ``ph: "X"`` (ts + dur, µs); the span tree's
                        parent links and, on the card, ``device_s``
                        ride in ``args``
``ev: ctr``             ``ph: "C"`` for numeric fields (a record with
                        none is an instant that keeps its strings)
``ev: proto``           ``ph: "i"`` (op + path in args)
process ``ctx.role``    ``ph: "M" process_name`` metadata
======================  =============================================

Timestamps are the records' epoch seconds, rebased to the earliest
record.  The document's ``otherData.source`` names the trace format's
exporter, ``repro.obs export-trace``, as the reference's does: the two
packages write the same document for the same trace.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from .trace import load_events


def _numeric(fields: Dict[str, Any]) -> Dict[str, float]:
    out = {}
    for k, v in fields.items():
        if isinstance(v, (bool, int, float)):
            out[k] = float(v)
    return out


def convert(events: List[dict]) -> Dict[str, Any]:
    """Obs records → ``{"traceEvents": [...], ...}`` (the JSON Object
    Format, so Perfetto takes metadata beside the array)."""
    spans = [ev for ev in events if ev.get("ev") == "span"]
    ctrs = [ev for ev in events if ev.get("ev") == "ctr"]
    protos = [ev for ev in events if ev.get("ev") == "proto"]
    t0 = min((float(ev["t"]) for ev in events if "t" in ev), default=0.0)

    def us(t: float) -> float:
        return (t - t0) * 1e6

    out: List[Dict[str, Any]] = []
    roles: Dict[int, str] = {}
    for ev in spans:
        ctx = ev.get("ctx") or {}
        pid = int(ev.get("pid", 0))
        if "role" in ctx:
            roles.setdefault(pid, str(ctx["role"]))
        args = dict(ev.get("attrs") or {})
        args["sid"] = ev.get("sid")
        if ev.get("parent") is not None:
            args["parent_sid"] = ev["parent"]
        if "device_s" in ev:
            args["device_s"] = ev["device_s"]
        out.append({"ph": "X", "name": str(ev.get("name", "?")), "pid": pid,
                    "tid": int(ev.get("tid", pid)), "ts": us(float(ev["t"])),
                    "dur": float(ev.get("dur", 0.0)) * 1e6, "cat": "span", "args": args})
    for ev in ctrs:
        pid = int(ev.get("pid", 0))
        fields = ev.get("fields") or {}
        nums = _numeric(fields)
        name = str(ev.get("name", "?"))
        # a counter keyed by a string field (kernel=..., site=...) gets one
        # track per value, so the series do not mix
        tags = [f"{k}={v}" for k, v in sorted(fields.items()) if isinstance(v, str)]
        track = name if not tags else f"{name}[{','.join(tags)}]"
        if nums:
            out.append({"ph": "C", "name": track, "pid": pid, "ts": us(float(ev.get("t", t0))),
                        "cat": "ctr", "args": nums})
        else:
            out.append({"ph": "i", "name": track, "pid": pid, "tid": int(ev.get("tid", pid)),
                        "ts": us(float(ev.get("t", t0))), "s": "p", "cat": "ctr",
                        "args": dict(fields)})
    for ev in protos:
        pid = int(ev.get("pid", 0))
        out.append({"ph": "i", "name": f"proto:{ev.get('op', '?')}", "pid": pid,
                    "tid": int(ev.get("tid", pid)), "ts": us(float(ev.get("t", t0))), "s": "p",
                    "cat": "proto", "args": {"path": ev.get("path"), **(ev.get("meta") or {})}})
    for pid, role in sorted(roles.items()):
        out.append({"ph": "M", "name": "process_name", "pid": pid,
                    "args": {"name": f"{role} (pid {pid})"}})
    out.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"source": "repro.obs export-trace", "t0_epoch_s": t0}}


def export(trace_path: str, out_path: str) -> Dict[str, int]:
    """Read a trace file or directory, write the Chrome JSON → event counts."""
    events = load_events(trace_path)
    doc = convert(events)
    with open(out_path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return {"events_in": len(events), "events_out": len(doc["traceEvents"])}


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs export-trace",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", help="trace file or directory (RCCA_TRACE dir)")
    ap.add_argument("-o", "--out", default="trace.json", help="output path (default: trace.json)")
    args = ap.parse_args(argv)
    n = export(args.trace, args.out)
    print(f"{args.out}: {n['events_out']} trace events (from {n['events_in']} obs records) — "
          "open in chrome://tracing or https://ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
