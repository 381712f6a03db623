#!/usr/bin/env python3
"""Measures the device-parallel topologies at Europarl width, outside
``chip_smoke.py``, on every visible card:

    PYTHONPATH=src python3 scripts/topologies_probe.py    # on one card, or four

First, on ``cuda:0``, two ``power_project_accumulate`` recompute launches
(cooperative grids) on two streams against one stream, at a shape whose
grid fills the card (8192 × 1024, k̃ = 970) and at the smoke width: the
time of a launch pair, bitwise equality with the one-stream result, and
a 60 s watchdog on the card (a hang exits non-zero).  Then phase 14's
store geometry (4,352 rows, 9 chunks of 512, ``--omega seeded``) with
merge groups of 2 (five groups) is ingested under ``build/`` and fitted
by ``exec.fit``: Local on ``cuda:0``, Sharded over every card (two slots
of ``cuda:0`` on a one-card host), Hybrid 2 × 2 over four cards (with
``combine_groups=4``: the disk holds the store, two 8.6 GB partials and
a round; skipped with fewer than four cards), then Local again.  Each
fit prints its wall, digests of ρ and Xa, launches in this process, the
peak memory per card and the topology's per-pass numbers; every fit
must be bitwise the first Local one, or the script exits non-zero.  The
store is deleted at the end.
"""
import json
import os
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.exec import Hybrid, Sharded, fit  # noqa: E402
from repro_torch.kernels import build, powerpass  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import cca_fit  # noqa: E402

WATCHDOG_S = 60.0
STORE = ROOT / "build" / "topologies_probe"


def cooperative_streams() -> dict:
    """Launch pairs of the fused power kernel on one stream and on two."""
    dev = torch.device("cuda:0")
    out = {}
    for label, (n, da, db, kt) in {"full grid 8192 x 1024, k~=970": (8192, 1024, 4096, 970),
                                   "smoke 512 x 256/192, k~=32": (512, 256, 192, 32)}.items():
        g = torch.Generator(device=dev).manual_seed(1)
        a = torch.randn(n, da, device=dev, generator=g)
        b = torch.randn(n, db, device=dev, generator=g)
        q = torch.randn(db, kt, device=dev, generator=g)
        ref = powerpass.power_project_accumulate(a, b, q, schedule="recompute")
        streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
        row = {}
        for k in (1, 2):
            reps, outs = 5, []
            ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            for s in streams[:k]:
                s.wait_stream(torch.cuda.current_stream(dev))
            ev0.record()
            for _ in range(reps):
                for s in streams[:k]:
                    with torch.cuda.stream(s):
                        outs.append(powerpass.power_project_accumulate(a, b, q,
                                                                       schedule="recompute"))
            for s in streams[:k]:
                torch.cuda.current_stream(dev).wait_stream(s)
            ev1.record()
            t0 = time.perf_counter()
            while not ev1.query():
                if time.perf_counter() - t0 > WATCHDOG_S:
                    print(f"[topologies] {label}: {k} stream(s) did not finish in "
                          f"{WATCHDOG_S} s", flush=True)
                    os._exit(3)
                time.sleep(0.01)
            row[f"{k} stream(s), ms a launch pair"] = ev0.elapsed_time(ev1) / reps * 2 / k
            row[f"{k} stream(s) bitwise"] = all(torch.equal(o, ref) for o in outs)
        row["ratio"] = row["2 stream(s), ms a launch pair"] / row["1 stream(s), ms a launch pair"]
        print(f"[topologies] cooperative launches, {label}: {row}", flush=True)
        out[label] = row
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("topologies_probe: needs CUDA", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cards = torch.cuda.device_count()
    print(f"[topologies] {cs.card_line()}; {cards} card(s)", flush=True)
    t0 = time.perf_counter()
    build.build()
    print(f"[topologies] build {time.perf_counter() - t0:.1f} s", flush=True)
    coop = cooperative_streams()
    shutil.rmtree(STORE, ignore_errors=True)
    STORE.mkdir(parents=True)
    try:
        wl = cs.europarl_store_wl()
        reader, secs = cca_fit.ingest(str(STORE / "europarl"), wl, seed=cs.SEED, device="cuda",
                                      rows_per_shard=cs.STORE_SHARD_ROWS)
        print(f"[topologies] store: {reader.n} rows, {reader.n_chunks} chunks, "
              f"{reader.nbytes / 1e9:.2f} GB in {secs:.1f} s", flush=True)
        slots = cards if cards > 1 else ("cuda:0", "cuda:0")
        runs = [("Local on cuda:0", {}),
                (f"Sharded over {slots}", {"topology": Sharded(devices=slots)})]
        if cards >= 4:
            runs.append(("Hybrid 2 x 2 over cuda:0-3, combine 4",
                         {"topology": Hybrid(2, 2), "cluster_dir": str(STORE / "cluster"),
                          "combine_groups": 4, "worker_timeout": 900}))
        runs.append(("Local on cuda:0 again", {}))
        got = {}
        for label, kw in runs:
            torch.cuda.empty_cache()
            for d in range(cards):
                torch.cuda.reset_peak_memory_stats(d)
            kops.reset_launch_counts()
            t0 = time.perf_counter()
            res = fit(reader, wl.rcca, cs.SEED, merge_group=2, omega="seeded", device="cuda",
                      **kw)
            for d in range(cards):
                torch.cuda.synchronize(d)
            wall = time.perf_counter() - t0
            got[label] = (cs.digest(res.rho), cs.digest(res.Xa))
            line = {"wall_s": round(wall, 3), "digests": got[label],
                    "sum_rho": float(res.rho.double().sum()), "launches": kops.launch_counts(),
                    "peak_gb_per_card": [round(torch.cuda.max_memory_allocated(d) / 1e9, 2)
                                         for d in range(cards)]}
            topo = res.diagnostics.get("topology")
            if topo is not None:
                line["passes"] = [{k: p[k] for k in ("seconds", "slot_device_s")}
                                  | {"read_s": p["io"]["read_s"], "stall_s": p["io"]["io_stall_s"]}
                                  for p in topo["passes"]]
            cl = res.diagnostics.get("cluster")
            if cl is not None:
                line["worker_slots"] = cl["worker_slots"]
                line["passes"] = [{k: p[k] for k in ("wall_s", "publish_s", "barrier_s", "merge_s",
                                                     "boundary_s", "launches")}
                                  | {"workers": [{k: w.get(k) for k in (
                                      "shard", "slots", "groups", "seconds", "slot_device_s",
                                      "peak_gb")} for w in p["workers"]]}
                                  for p in cl["passes"]]
                shutil.rmtree(STORE / "cluster", ignore_errors=True)
            print(f"[topologies] {label}: {json.dumps(line)}", flush=True)
            del res
        same = len(set(got.values())) == 1
        print(f"[topologies] every fit bitwise the first Local fit: {same}", flush=True)
        print(json.dumps({"cooperative": coop, "bitwise": same}), flush=True)
        return 0 if same and all(r["1 stream(s) bitwise"] and r["2 stream(s) bitwise"]
                                 for r in coop.values()) else 1
    finally:
        shutil.rmtree(STORE, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
