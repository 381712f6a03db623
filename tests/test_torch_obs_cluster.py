"""A traced two-worker Cluster fit of the port (``repro_torch.obs`` across
processes).

Each fit runs in a process of its own, joined with its own time limit,
with ``RCCA_TRACE`` in its environment; the coordinator passes the
variable on to the worker processes it spawns.

- the spans nest in every process, their parents resolve, every process
  has a role and ≥ 95 % of its traced window inside top-level spans, the
  coordinator's publish, barrier and merge spans are its diagnostics'
  seconds (one clock), the workers' ``kernel_cost`` counters are the cost
  model's, and the protocol events show no violation;
- a worker killed mid-pass (``RCCA_CLUSTER_KILL_AT``) leaves a trace that
  parses, a torn last line included, with the re-dispatch and every
  group's publication in it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.obs import report as jreport
from repro_torch.core import rcca as tr
from repro_torch.data import PlantedCCAData
from repro_torch.kernels import ops
from repro_torch.obs import load_events
from repro_torch.obs import report as treport
from repro_torch.store import ingest_planted

ROOT = Path(__file__).resolve().parents[1]
N, DA, DB, CHUNK = 1024, 24, 16, 128  # 8 chunks
G = 2  # 4 merge groups, 2 a worker
CFG = dict(k=3, p=5, q=1, nu=0.01, center=True)
FIT_TIMEOUT_S = 300.0

CHILD = """
import json, sys
from repro_torch.cluster.worker import KILL_ENV
from repro_torch.core.rcca import RCCAConfig
from repro_torch.exec import Cluster, fit
store, cluster_dir, kill = sys.argv[1], sys.argv[2], sys.argv[3] == "kill"
res = fit(store, RCCAConfig(**json.loads(sys.argv[4])), 7, topology=Cluster(n_workers=2),
          cluster_dir=cluster_dir, merge_group=2, device="cpu", worker_timeout=240,
          env_overrides={0: {KILL_ENV: "0:2"}} if kill else None)
print(json.dumps(res.diagnostics["cluster"]["passes"]))
"""


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    data = PlantedCCAData(n=N, da=DA, db=DB, rank=4, noise=0.4, seed=13, chunk=CHUNK)
    return ingest_planted(str(tmp_path_factory.mktemp("obs_cluster") / "store"), data)


def _traced_cluster_fit(store, tmp: Path, kill: bool):
    """(trace directory, the passes' diagnostics) of one traced cluster fit."""
    trace_dir = tmp / "trace"
    env = {**os.environ, "RCCA_TRACE": str(trace_dir),
           "PYTHONPATH": str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run([sys.executable, "-c", CHILD, store.path, str(tmp / "cl"),
                          "kill" if kill else "clean", json.dumps(CFG)],
                         env=env, capture_output=True, text=True, timeout=FIT_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    return str(trace_dir), json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def clean_fit(store, tmp_path_factory):
    return _traced_cluster_fit(store, tmp_path_factory.mktemp("clean"), kill=False)


def test_cluster_trace_nests_covers_and_passes_the_protocol(clean_fit):
    trace_dir, passes = clean_fit
    events = load_events(trace_dir)
    spans = [ev for ev in events if ev.get("ev") == "span"]
    by_pid = {}
    for sp in spans:
        by_pid.setdefault(sp["pid"], {})[sp["sid"]] = sp
    assert len(by_pid) == 5  # the coordinator and two workers a pass
    for pid, sids in by_pid.items():
        for sp in sids.values():
            if sp["parent"] is None:
                continue
            parent = sids.get(sp["parent"])
            assert parent is not None, f"pid {pid}: {sp['name']} has a dangling parent"
            # the child's window inside the parent's (t is the wall clock, dur
            # the monotonic one: 50 ms of slack)
            assert sp["t"] >= parent["t"] - 0.05
            assert sp["t"] + sp["dur"] <= parent["t"] + parent["dur"] + 0.05
    roles = sorted({sp["ctx"]["role"] for sp in spans})
    assert roles == ["coordinator", "worker000", "worker001"]

    rep = treport.analyze(trace_dir)
    assert rep == jreport.analyze(trace_dir)
    for proc in rep["processes"].values():
        assert proc["coverage"]["fraction"] >= 0.95, proc
    assert rep["protocol"]["violations"] == [] and rep["protocol"]["events"] > 0
    assert rep["redispatches"] == 0
    coord = next(p for p in rep["processes"].values() if p["role"] == "coordinator")
    for phase in ("fit", "pass", "publish", "barrier", "merge"):
        assert coord["phases"][phase]["n"] == (1 if phase == "fit" else 2)
    workers = [p for p in rep["processes"].values() if p["role"] != "coordinator"]
    assert all(p["phases"]["worker_pass"]["n"] == 1 and p["phases"]["publish"]["n"] == 2
               for p in workers)

    # the coordinator's spans and its diagnostics read one clock
    coord_spans = [sp for sp in spans if sp["ctx"]["role"] == "coordinator"]
    for name, key in (("publish", "publish_s"), ("barrier", "barrier_s"), ("merge", "merge_s")):
        got = [sp["dur"] for sp in coord_spans if sp["name"] == name]
        want = [p[key] for p in passes]
        assert all(abs(g - w) <= 0.010 for g, w in zip(got, want)) and len(got) == 2, \
            (name, got, want)

    # the workers' kernel_cost counters are the cost model's
    counted = {}
    for ev in events:
        if ev.get("ev") == "ctr" and ev["name"] == "kernel_cost":
            counted[ev["fields"]["kernel"]] = (counted.get(ev["fields"]["kernel"], 0)
                                               + ev["fields"]["calls"])
    want = {}
    for kind in ("power", "final"):
        for part in ops.chunk_cost(kind, CHUNK, DA, DB, tr.RCCAConfig(**CFG).sketch)["entries"]:
            want[part["kernel"]] = want.get(part["kernel"], 0) + part["calls"] * (N // CHUNK)
    assert counted == want


def test_killed_worker_leaves_a_parseable_trace(store, tmp_path):
    trace_dir, passes = _traced_cluster_fit(store, tmp_path, kill=True)
    assert passes[0]["redispatched_groups"] == [2]
    files = sorted(os.listdir(trace_dir))
    with open(os.path.join(trace_dir, files[0]), "a") as f:
        f.write('{"ev": "span", "name": "torn')  # the torn last line a kill can leave
    events = load_events(trace_dir)
    assert all(isinstance(ev, dict) for ev in events)
    rep = treport.analyze(trace_dir)
    assert rep == jreport.analyze(trace_dir)
    assert rep["redispatches"] == 1
    assert rep["protocol"]["violations"] == []
    # the killed worker's spans up to its death, and the repair's, are there
    publishes = [ev for ev in events if ev.get("ev") == "span" and ev["name"] == "publish"
                 and ev["ctx"]["role"].startswith("worker")]
    assert len(publishes) >= 2 * (N // CHUNK // G)  # every group of both passes
    assert {ev["ctx"]["role"] for ev in publishes} >= {"worker000", "worker001", "worker002"}
