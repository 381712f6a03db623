"""Offline analysis of an ``RCCA_TRACE`` directory: timeline and roofline.

    python -m repro_torch.obs report rcca_trace [--json out.json]

Port of ``repro/obs/report.py``.  Reads every per-process
``trace-*.jsonl`` file and reconstructs:

* **timeline**: per process (coordinator, workers, launcher), the
  top-level spans and per span name the count, seconds and self-seconds
  (duration less the direct children's), so a fit's wall decomposes into
  named phases: fit > pass > chunk / io_wait / publish / barrier /
  merge.  Where the spans of a name carry ``device_s`` (spans around
  work on the card), their sum is beside it;
* **coverage**: the share of each process's traced window inside its
  top-level spans (the instrumentation's bar is ≥ 0.95);
* **roofline**: per-kernel cost-model totals from the ``kernel_cost``
  counters (calls, FLOPs, bytes, FLOPs per byte), and per pass kind and
  engine the fold spans' modelled FLOPs over their time.  A fold row
  whose every ``chunk`` span carries ``device_s`` divides by the card's
  seconds and says so (``"clock": "device_s"``); any other divides by
  the host ``dur``, as the reference does;
* **io overlap**: per prefetch site, the share of read time hidden
  behind the fold, ``(read_s − io_stall_s) / read_s``, from the ``io``
  counters;
* **merge share**: merge-tree seconds over the coordinator's fit wall;
* **liveness**: the heartbeat ages the coordinator saw at its barrier;
* **redispatches** and the **protocol** verdict (RCCA201-204 over the
  ``proto`` records, :func:`repro_torch.analysis.protocol.check_trace`).

On a trace with no ``device_s`` (any CPU fit, and every reference
trace) :func:`analyze` returns the reference's dict, key for key.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from .trace import load_events

#: span names whose time is a leaf fold phase (``mesh_fold``: one batch of
#: the device-parallel fold, ``exec.fold_groups_on_mesh``, whose ``chunk``
#: spans carry no cost, so a batch counts once; timed by the host clock)
_FOLD_SPANS = ("chunk", "mesh_fold")


def _spans_by_pid(events: List[dict]) -> Dict[int, List[dict]]:
    out: Dict[int, List[dict]] = {}
    for ev in events:
        if ev.get("ev") == "span":
            out.setdefault(int(ev.get("pid", 0)), []).append(ev)
    return out


def _self_times(spans: List[dict]) -> None:
    """Annotate each span dict with ``self`` = dur − Σ direct children's
    durs, clamped at 0 (a child over its parent's edge is a clock
    artifact, not negative work)."""
    child_sum: Dict[Any, float] = {}
    for sp in spans:
        if sp.get("parent") is not None:
            child_sum[sp["parent"]] = child_sum.get(sp["parent"], 0.0) + float(sp.get("dur", 0.0))
    for sp in spans:
        sp["self"] = max(0.0, float(sp.get("dur", 0.0)) - child_sum.get(sp.get("sid"), 0.0))


def _role(spans: List[dict]) -> str:
    for sp in spans:
        ctx = sp.get("ctx") or {}
        if "role" in ctx:
            return str(ctx["role"])
    return "proc"


def _coverage(spans: List[dict]) -> Dict[str, float]:
    """Top-level span seconds against the process's traced window."""
    t0 = min(float(sp["t"]) for sp in spans)
    t1 = max(float(sp["t"]) + float(sp.get("dur", 0.0)) for sp in spans)
    covered = sum(float(sp.get("dur", 0.0)) for sp in spans if sp.get("parent") is None)
    window = max(t1 - t0, 1e-12)
    return {"window_s": window, "covered_s": covered, "fraction": min(1.0, covered / window)}


def analyze(path: str) -> Dict[str, Any]:
    """The full report dict of a trace file or directory."""
    events = load_events(path)
    by_pid = _spans_by_pid(events)
    report: Dict[str, Any] = {"trace": path, "n_events": len(events)}

    # -- timeline + coverage ------------------------------------------
    procs: Dict[str, Any] = {}
    trace_t0 = min((float(sp["t"]) for sps in by_pid.values() for sp in sps), default=0.0)
    for pid, spans in sorted(by_pid.items()):
        _self_times(spans)
        phases: Dict[str, Dict[str, float]] = {}
        for sp in spans:
            ph = phases.setdefault(sp["name"], {"n": 0, "s": 0.0, "self_s": 0.0})
            ph["n"] += 1
            ph["s"] += float(sp.get("dur", 0.0))
            ph["self_s"] += float(sp["self"])
            if "device_s" in sp:
                ph["device_s"] = ph.get("device_s", 0.0) + float(sp["device_s"])
        top = [{"name": sp["name"], "t": round(float(sp["t"]) - trace_t0, 4),
                "dur": round(float(sp.get("dur", 0.0)), 4), "attrs": sp.get("attrs", {})}
               for sp in sorted((s for s in spans if s.get("parent") is None),
                                key=lambda s: float(s["t"]))]
        procs[str(pid)] = {
            "role": _role(spans),
            "top_spans": top,
            "phases": {k: {kk: round(vv, 4) if isinstance(vv, float) else vv
                           for kk, vv in v.items()}
                       for k, v in sorted(phases.items())},
            "coverage": {k: round(v, 4) if isinstance(v, float) else v
                         for k, v in _coverage(spans).items()},
        }
    report["processes"] = procs
    fracs = [p["coverage"]["fraction"] for p in procs.values()]
    report["coverage"] = round(min(fracs), 4) if fracs else 0.0

    # -- roofline -----------------------------------------------------
    kernels: Dict[str, Dict[str, float]] = {}
    for ev in events:
        if ev.get("ev") == "ctr" and ev.get("name") == "kernel_cost":
            f = ev.get("fields", {})
            k = kernels.setdefault(str(f.get("kernel", "?")), {"calls": 0, "flops": 0, "bytes": 0})
            k["calls"] += int(f.get("calls", 0))
            k["flops"] += int(f.get("flops", 0))
            k["bytes"] += int(f.get("bytes", 0))
    folds: Dict[Any, Dict[str, Any]] = {}
    for spans in by_pid.values():
        for sp in spans:
            if sp["name"] not in _FOLD_SPANS:
                continue
            a = sp.get("attrs", {})
            if "flops" not in a:
                continue
            key = (str(a.get("kind", "?")), str(a.get("engine", "?")))
            fd = folds.setdefault(key, {"s": 0.0, "flops": 0, "bytes": 0, "n": 0,
                                        "device_s": 0.0, "on_device": 0})
            fd["s"] += float(sp.get("dur", 0.0))
            fd["flops"] += int(a["flops"])
            fd["bytes"] += int(a.get("bytes", 0))
            fd["n"] += 1
            if "device_s" in sp:
                fd["device_s"] += float(sp["device_s"])
                fd["on_device"] += 1
    rows: Dict[str, Dict[str, Any]] = {}
    for (kind, engine), fd in sorted(folds.items()):
        device = fd["on_device"] == fd["n"]
        secs = fd["device_s"] if device else fd["s"]
        row: Dict[str, Any] = {"n": fd["n"], "s": round(secs, 4), "flops": fd["flops"],
                               "bytes": fd["bytes"],
                               "model_gflops_per_s": round(fd["flops"] / secs / 1e9, 3)
                               if secs else None}
        if device:
            row["clock"] = "device_s"
        rows[f"{kind}/{engine}"] = row
    report["roofline"] = {
        "kernels": {k: dict(v, intensity=round(v["flops"] / v["bytes"], 3)
                            if v["bytes"] else None)
                    for k, v in sorted(kernels.items())},
        "folds": rows,
    }

    # -- io overlap ---------------------------------------------------
    io: Dict[str, Dict[str, float]] = {}
    for ev in events:
        if ev.get("ev") == "ctr" and ev.get("name") == "io":
            f = ev.get("fields", {})
            s = io.setdefault(str(f.get("site", "?")),
                              {"chunks": 0, "bytes": 0, "read_s": 0.0, "io_stall_s": 0.0})
            s["chunks"] += int(f.get("chunks", 0))
            s["bytes"] += int(f.get("bytes", 0))
            s["read_s"] += float(f.get("read_s", 0.0))
            s["io_stall_s"] += float(f.get("io_stall_s", 0.0))
    report["io"] = {
        site: dict(v, read_s=round(v["read_s"], 4), io_stall_s=round(v["io_stall_s"], 4),
                   overlap=round((v["read_s"] - v["io_stall_s"]) / v["read_s"], 4)
                   if v["read_s"] else None)
        for site, v in sorted(io.items())
    }

    # -- merge share --------------------------------------------------
    merge_s = fit_s = 0.0
    for spans in by_pid.values():
        for sp in spans:
            if sp["name"] == "merge":
                merge_s += float(sp.get("dur", 0.0))
            elif sp["name"] == "fit" and sp.get("attrs", {}).get("site") == "coordinator":
                fit_s += float(sp.get("dur", 0.0))
    report["merge"] = {"merge_s": round(merge_s, 4), "fit_s": round(fit_s, 4),
                       "share": round(merge_s / fit_s, 4) if fit_s else None}

    # -- worker liveness ----------------------------------------------
    beats: Dict[int, Dict[str, Any]] = {}
    for ev in events:
        if ev.get("ev") == "ctr" and ev.get("name") == "heartbeat":
            f = ev.get("fields", {})
            s = beats.setdefault(int(f.get("shard", -1)), {"samples": 0, "max_age_s": 0.0,
                                                           "last_age_s": 0.0, "passes": set()})
            age = float(f.get("age_s", 0.0))
            s["samples"] += 1
            s["max_age_s"] = max(s["max_age_s"], age)
            s["last_age_s"] = age
            s["passes"].add(int(f.get("pass_idx", -1)))
    report["liveness"] = {
        str(shard): {"samples": v["samples"], "max_age_s": round(v["max_age_s"], 3),
                     "last_age_s": round(v["last_age_s"], 3), "passes": sorted(v["passes"])}
        for shard, v in sorted(beats.items())
    }

    # -- redispatches + protocol verdict ------------------------------
    report["redispatches"] = sum(
        int(ev.get("fields", {}).get("groups", 0)) for ev in events
        if ev.get("ev") == "ctr" and ev.get("name") == "redispatch")
    proto = [ev for ev in events if ev.get("ev") == "proto"]
    if proto:
        from ..analysis.protocol import check_trace

        # per-process files concatenate in name order; the wall stamp
        # recovers the cross-process order the invariants are stated over
        proto.sort(key=lambda ev: float(ev.get("t", 0.0)))
        violations = check_trace(proto, where=path)
        report["protocol"] = {"events": len(proto), "violations": [str(v) for v in violations]}
    return report


def render(report: Dict[str, Any]) -> str:
    """The text of an :func:`analyze` dict, one section after another."""
    out: List[str] = []
    out.append(f"trace: {report['trace']}  ({report['n_events']} events, "
               f"{len(report['processes'])} processes)")
    out.append("")
    out.append("timeline")
    for pid, proc in report["processes"].items():
        cov = proc["coverage"]
        out.append(f"  [{proc['role']} pid={pid}]  window {cov['window_s']:.3f}s, "
                   f"coverage {cov['fraction']:.1%}")
        for sp in proc["top_spans"]:
            attrs = sp["attrs"]
            tag = " ".join(f"{k}={attrs[k]}" for k in sorted(attrs)
                           if k in ("site", "pass_idx", "kind", "engine", "schedule"))
            out.append(f"    +{sp['t']:8.3f}s  {sp['name']:<12} {sp['dur']:8.3f}s  {tag}")
        for name, ph in proc["phases"].items():
            dev = f"  device={ph['device_s']:9.3f}s" if "device_s" in ph else ""
            out.append(f"      {name:<12} n={ph['n']:<5d} sum={ph['s']:9.3f}s  "
                       f"self={ph['self_s']:9.3f}s{dev}")
    out.append("")
    out.append(f"span coverage (min over processes): {report['coverage']:.1%}")
    out.append("")
    out.append("roofline — cost-model kernel totals")
    out.append(f"  {'kernel':<26} {'calls':>7} {'flops':>16} {'bytes':>16} {'flops/byte':>10}")
    for k, v in report["roofline"]["kernels"].items():
        inten = f"{v['intensity']:.2f}" if v["intensity"] else "-"
        out.append(f"  {k:<26} {v['calls']:>7d} {v['flops']:>16d} {v['bytes']:>16d} "
                   f"{inten:>10}")
    out.append("  fold spans (cost-model work over the fold's time):")
    for key, fd in report["roofline"]["folds"].items():
        gf = (f"{fd['model_gflops_per_s']:.3f} model-GFLOP/s"
              if fd["model_gflops_per_s"] is not None else "-")
        clock = "device time" if fd.get("clock") == "device_s" else "host wall"
        out.append(f"    {key:<16} n={fd['n']:<5d} {fd['s']:8.3f}s ({clock})  {gf}")
    out.append("")
    out.append("io overlap")
    for site, v in report["io"].items():
        ov = f"{v['overlap']:.1%}" if v["overlap"] is not None else "-"
        out.append(f"  {site:<14} chunks={v['chunks']:<6d} read={v['read_s']:.3f}s "
                   f"stall={v['io_stall_s']:.3f}s overlap={ov}")
    m = report["merge"]
    share = f"{m['share']:.1%}" if m["share"] is not None else "-"
    out.append("")
    out.append(f"merge tree: {m['merge_s']:.3f}s of {m['fit_s']:.3f}s coordinator fit wall "
               f"({share})")
    if report.get("liveness"):
        out.append("")
        out.append("worker liveness (heartbeat ages seen at the barrier)")
        for shard, v in report["liveness"].items():
            passes = ",".join(str(p) for p in v["passes"])
            out.append(f"  shard {shard:>3}  samples={v['samples']:<5d} "
                       f"max_age={v['max_age_s']:.3f}s last_age={v['last_age_s']:.3f}s  "
                       f"passes=[{passes}]")
    if report["redispatches"]:
        out.append(f"redispatched groups: {report['redispatches']}")
    if "protocol" in report:
        p = report["protocol"]
        verdict = "OK" if not p["violations"] else "VIOLATIONS"
        out.append(f"protocol: {p['events']} events -> {verdict}")
        for v in p["violations"]:
            out.append(f"  {v}")
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs report",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", help="trace file or directory (RCCA_TRACE dir)")
    ap.add_argument("--json", default=None, help="also write the full report dict to this path")
    args = ap.parse_args(argv)
    report = analyze(args.trace)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
    print(render(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
