"""The port's observability layer (``repro_torch.obs``) and protocol
recorder (``repro_torch.analysis``) against the reference's.

Every comparison with the reference is exact: the two packages run the
same pure-Python arithmetic over the same records.

- each package's ``report.analyze`` and ``chrometrace.convert`` give the
  same output on the other package's trace of the same Local store fit;
- the two fits, on the same store and Ω, record the same span tree
  (fit / pass / io_wait / chunk);
- tracing off is bitwise invisible and creates no file, under both
  engines, and the traced fold still releases each chunk before pulling
  the next; a trace file deleted under a tracing process is written
  anew, and ``close`` releases the files;
- the ``kernel_cost`` counters are ``ops.chunk_cost`` per entry point
  times the chunks;
- the report on synthetic traces: a torn last line, the fold rows'
  fallback to ``dur`` where there is no ``device_s``, and device spans
  resolved by one synchronisation, with stand-in events, each stamped
  with the context its span ended in;
- ``cca_serve --smoke --device cpu --trace`` records what the card's
  smoke run checks, and ``cca_fit --trace`` prints its report;
- the port's and the reference's ``check_trace`` give the same findings,
  one case for each of RCCA201-204, and ``trace_event`` records only
  into the ``RCCA_TRACE`` stream.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import protocol as jprotocol
from repro.core import rcca as jr
from repro.exec import fit as j_fit
from repro.obs import chrometrace as jchrome
from repro.obs import report as jreport
from repro_torch import obs
from repro_torch.analysis import protocol as tprotocol
from repro_torch.core import rcca as tr
from repro_torch.data import PlantedCCAData
from repro_torch.exec import PassEngine
from repro_torch.exec import fit as t_fit
from repro_torch.kernels import ops
from repro_torch.launch import cca_fit, cca_serve
from repro_torch.obs import chrometrace as tchrome
from repro_torch.obs import report as treport
from repro_torch.obs import trace as ttrace
from repro_torch.store import ingest_planted

ROOT = Path(__file__).resolve().parents[1]
N, DA, DB, CHUNK = 1024, 24, 16, 128  # 8 chunks
G = 2  # 4 merge groups
CFG = dict(k=3, p=5, q=1, nu=0.01, center=True)
KEY = 7


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    data = PlantedCCAData(n=N, da=DA, db=DB, rank=4, noise=0.4, seed=13, chunk=CHUNK)
    return ingest_planted(str(tmp_path_factory.mktemp("obs") / "store"), data)


def _omega(kt):
    """The reference's materialized Ω for ``PRNGKey(KEY)``, as numpy."""
    ka, kb = jax.random.split(jax.random.PRNGKey(KEY))
    return (np.array(jax.random.normal(ka, (DA, kt), jnp.float32)),
            np.array(jax.random.normal(kb, (DB, kt), jnp.float32)))


def _port_fit(store, engine="kernels"):
    cfg = tr.RCCAConfig(**CFG)
    Qa, Qb = _omega(cfg.sketch)
    return t_fit(store, cfg, Qa=Qa, Qb=Qb, engine=engine, merge_group=G, device="cpu")


def _traced(path, fn, *args, **kwargs):
    """``fn`` with ``RCCA_TRACE=path``, the variable restored after."""
    old = os.environ.get("RCCA_TRACE")
    os.environ["RCCA_TRACE"] = str(path)
    try:
        return fn(*args, **kwargs)
    finally:
        if old is None:
            del os.environ["RCCA_TRACE"]
        else:
            os.environ["RCCA_TRACE"] = old


@pytest.fixture(scope="module")
def traces(store, tmp_path_factory):
    """The reference's (jnp engine) and the port's (kernels engine, plain
    versions) trace of the Local store fit on the same store and Ω."""
    tmp = tmp_path_factory.mktemp("traces")
    _traced(tmp / "reference", j_fit, store.path, jr.RCCAConfig(**CFG), jax.random.PRNGKey(KEY),
            engine="jnp", merge_group=G)
    _traced(tmp / "port", _port_fit, store)
    return {"reference": str(tmp / "reference"), "port": str(tmp / "port")}


def _files(root: Path, sub: str):
    return sorted((root / "src" / "repro_torch" / sub).rglob("*.py"))


FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)\b(?!_)", re.MULTILINE)


def test_obs_and_analysis_import_neither_jax_nor_the_reference():
    files = _files(ROOT, "obs") + _files(ROOT, "analysis")
    assert len(files) == 13
    hits = [f"{f.name}: {m.group(0).strip()}" for f in files
            for m in FORBIDDEN.finditer(f.read_text())]
    assert hits == []
    # torch loads inside functions only: trace.py's CUDA events, the
    # sanitizer's copies of device leaves, the explorer's payloads and the
    # kernel gate's device
    torch_imports = [f.name for f in files if re.search(r"^\s*import torch", f.read_text(),
                                                        re.MULTILINE)]
    assert sorted(torch_imports) == ["kernel_check.py", "protocol.py", "sanitize.py", "trace.py"]
    assert not [f.name for f in files if re.search(r"^import torch", f.read_text(), re.MULTILINE)]
    code = ("import sys; import repro_torch.obs, repro_torch.obs.report, "
            "repro_torch.obs.chrometrace, repro_torch.obs.cost, repro_torch.analysis, "
            "repro_torch.analysis.lint, repro_torch.analysis.kernel_check, "
            "repro_torch.analysis.protocol, repro_torch.analysis.sanitize, "
            "repro_torch.analysis.__main__; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("which", ["reference", "port"])
def test_each_package_reads_the_others_trace(traces, which):
    path = traces[which]
    assert treport.analyze(path) == jreport.analyze(path)
    events = ttrace.load_events(path)
    assert tchrome.convert(events) == jchrome.convert(events)
    assert treport.render(treport.analyze(path)).startswith(f"trace: {path}")


def _tree(path):
    """(name, parent's name, pass_idx, kind, chunk) of the fit, pass,
    io_wait and chunk spans, in file order."""
    spans = [ev for ev in ttrace.load_events(path) if ev.get("ev") == "span"]
    names = {ev["sid"]: ev["name"] for ev in spans}
    return [(ev["name"], names.get(ev["parent"]), ev.get("attrs", {}).get("pass_idx"),
             ev.get("attrs", {}).get("kind"), ev.get("attrs", {}).get("chunk"))
            for ev in spans if ev["name"] in ("fit", "pass", "io_wait", "chunk")]


def test_the_two_fits_record_the_same_span_tree(traces):
    ref, port = _tree(traces["reference"]), _tree(traces["port"])
    assert ref == port
    nc = N // CHUNK
    assert [t[0] for t in port].count("chunk") == 2 * nc
    assert [t[0] for t in port].count("io_wait") == 2 * (nc + 1)  # the last pull ends the pass
    assert port[-1] == ("fit", None, None, None, None)


@pytest.mark.parametrize("engine", ["kernels", "torch"])
def test_trace_off_is_bitwise_invisible(store, tmp_path, monkeypatch, engine):
    trace_dir = tmp_path / "trace"
    traced = _traced(trace_dir, _port_fit, store, engine)
    assert os.listdir(trace_dir)
    monkeypatch.delenv("RCCA_TRACE", raising=False)
    monkeypatch.chdir(tmp_path)  # a stray default rcca_trace/ would land here
    plain = _port_fit(store, engine)
    for f in ("Xa", "Xb", "rho", "Qa", "Qb"):
        assert torch.equal(getattr(traced, f), getattr(plain, f)), f
    assert sorted(os.listdir(tmp_path)) == ["trace"]


def test_traced_fold_releases_each_chunk_before_the_next(tmp_path, monkeypatch):
    """The traced loop keeps the fold's memory contract: at Europarl width
    a chunk pair is 34 GB and two do not fit."""
    made = []
    g = torch.Generator()
    g.manual_seed(0)

    def make():
        a, b = torch.randn((16, 5), generator=g), torch.randn((16, 4), generator=g)
        made.append((weakref.ref(a), weakref.ref(b)))
        return a, b

    def source():
        for _ in range(5):
            assert all(r() is None for pair in made for r in pair), "a chunk outlived its fold"
            yield make()

    monkeypatch.setenv("RCCA_TRACE", str(tmp_path / "t"))
    PassEngine(tr.RCCAConfig(k=1, p=2, q=1), device="cpu").run_stream(
        source, 5, 4, torch.randn((5, 3), generator=g), torch.randn((4, 3), generator=g),
        n_chunks=5)
    assert len(made) == 10


def test_a_deleted_trace_is_written_anew(store, tmp_path):
    """A fit that still traces after its trace directory was deleted
    writes a new file there, not into the deleted one, so a variable
    left set shows."""
    trace_dir = tmp_path / "t"
    _traced(trace_dir, _port_fit, store)
    shutil.rmtree(trace_dir)
    _traced(trace_dir, _port_fit, store)
    assert os.listdir(trace_dir) == [f"trace-{os.getpid()}.jsonl"]
    assert [e["name"] for e in ttrace.load_events(str(trace_dir)) if e["ev"] == "span"][-1] \
        == "fit"


def test_close_releases_the_files_and_the_next_record_reopens(tmp_path, monkeypatch):
    monkeypatch.setenv("RCCA_TRACE", str(tmp_path / "t"))
    path = str(tmp_path / "t" / f"trace-{os.getpid()}.jsonl")
    obs.counter("first", x=1)
    assert path in ttrace._FDS
    obs.close()
    assert not ttrace._FDS
    obs.counter("second", x=2)
    assert [e["name"] for e in ttrace.load_events(path)] == ["first", "second"]


def test_kernel_cost_counters_are_the_cost_model(traces):
    counted, flops = {}, {"power": 0, "final": 0}
    for ev in ttrace.load_events(traces["port"]):
        if ev.get("ev") == "ctr" and ev["name"] == "kernel_cost":
            t = counted.setdefault(ev["fields"]["kernel"], {"calls": 0, "flops": 0, "bytes": 0})
            for k in t:
                t[k] += ev["fields"][k]
        elif ev.get("ev") == "span" and ev["name"] == "chunk":
            flops[ev["attrs"]["kind"]] += ev["attrs"]["flops"]
    nc, kt = N // CHUNK, tr.RCCAConfig(**CFG).sketch
    want, want_flops = {}, {}
    for kind in ("power", "final"):
        cost = ops.chunk_cost(kind, CHUNK, DA, DB, kt)
        want_flops[kind] = cost["flops"] * nc
        for part in cost["entries"]:
            t = want.setdefault(part["kernel"], {"calls": 0, "flops": 0, "bytes": 0})
            for k in t:
                t[k] += part[k] * nc
    assert counted == want
    assert flops == want_flops
    assert set(counted) == {"power_project_accumulate", "projgram", "matmul_tn"}


def test_torch_engine_chunks_carry_no_cost(store, tmp_path):
    _traced(tmp_path / "t", _port_fit, store, "torch")
    events = ttrace.load_events(str(tmp_path / "t"))
    chunks = [ev for ev in events if ev.get("ev") == "span" and ev["name"] == "chunk"]
    assert len(chunks) == 2 * (N // CHUNK) and not any("flops" in ev["attrs"] for ev in chunks)
    assert not [ev for ev in events if ev.get("name") == "kernel_cost"]


# --------------------------------------------------------------------------
# the report on synthetic traces
# --------------------------------------------------------------------------


def _span(name, t, dur, sid, parent=None, pid=1, **extra):
    rec = {"ev": "span", "name": name, "t": t, "dur": dur, "sid": sid, "parent": parent,
           "pid": pid, "tid": pid}
    rec.update(extra)
    return rec


def _write(path, recs, torn=None):
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
        if torn:
            f.write(torn)


def test_report_skips_a_torn_last_line(tmp_path):
    recs = [_span("fit", 0.0, 2.0, 1), _span("pass", 0.0, 1.9, 2, 1)]
    _write(tmp_path / "trace-1.jsonl", recs, torn='{"ev": "span", "name": "chu')
    assert ttrace.load_events(str(tmp_path)) == recs
    rep = treport.analyze(str(tmp_path))
    assert rep == jreport.analyze(str(tmp_path))
    assert rep["n_events"] == 2 and rep["coverage"] == 1.0


@pytest.mark.parametrize("device_s", ["none", "some", "all"])
def test_fold_rows_use_device_seconds_only_where_every_span_has_them(tmp_path, device_s):
    recs = [_span("fit", 0.0, 10.0, 1)]
    for i in range(4):
        extra = {}
        if device_s == "all" or (device_s == "some" and i % 2):
            extra["device_s"] = 2.0
        recs.append(_span("chunk", 1.0 + i, 0.5, 2 + i, 1,
                          attrs={"kind": "power", "engine": "kernels", "flops": 10**12,
                                 "bytes": 10**9}, **extra))
    _write(tmp_path / "trace-1.jsonl", recs)
    rep = treport.analyze(str(tmp_path))
    row = rep["roofline"]["folds"]["power/kernels"]
    if device_s == "all":
        assert row == {"n": 4, "s": 8.0, "flops": 4 * 10**12, "bytes": 4 * 10**9,
                       "model_gflops_per_s": 500.0, "clock": "device_s"}
        assert rep["processes"]["1"]["phases"]["chunk"]["device_s"] == 8.0
        assert "(device time)" in treport.render(rep)
    else:
        assert row == {"n": 4, "s": 2.0, "flops": 4 * 10**12, "bytes": 4 * 10**9,
                       "model_gflops_per_s": 2000.0}
        assert "(host wall)" in treport.render(rep)
    if device_s == "none":  # the reference's report, key for key
        assert rep == jreport.analyze(str(tmp_path))


class _Event:
    """A stand-in CUDA timing event: each one made advances a clock by
    1.5 ms; ``elapsed_time`` is in ms, as CUDA's."""

    clock = 0.0
    synced: list = []
    broken = False

    def __init__(self):
        _Event.clock += 1.5
        self.t = _Event.clock

    def synchronize(self):
        _Event.synced.append(self)

    def elapsed_time(self, end):
        if _Event.broken:
            raise RuntimeError("event not recorded")
        return end.t - self.t


@pytest.fixture
def fake_events(monkeypatch, tmp_path):
    made = []

    def record(device):
        made.append(_Event())
        return made[-1]

    _Event.clock, _Event.synced, _Event.broken = 0.0, [], False
    monkeypatch.setattr(ttrace, "_record_event", record)
    monkeypatch.setenv("RCCA_TRACE", str(tmp_path / "t"))
    return made


def _records(tmp_path):
    d = tmp_path / "t"
    return ttrace.load_events(str(d)) if d.exists() else []


def test_device_spans_resolve_at_the_pass_exit_with_one_wait(fake_events, tmp_path):
    card = torch.device("cuda")
    with obs.span("pass", pass_idx=0):
        for i in range(3):
            with obs.device_span("io_wait", card, pass_idx=0):
                pass
            with obs.device_span("chunk", card, pass_idx=0, chunk=i):
                with obs.span("publish", group=i):  # a host span inside: written at once
                    pass
        assert [r["name"] for r in _records(tmp_path)] == ["publish"] * 3
    recs = _records(tmp_path)
    assert [r["name"] for r in recs] == ["publish"] * 3 + ["io_wait", "chunk"] * 3 + ["pass"]
    assert all(r["device_s"] == 0.0015 for r in recs if r["name"] in ("io_wait", "chunk"))
    assert "device_s" not in recs[-1] and "device_s" not in recs[0]
    assert _Event.synced == [fake_events[-1]]  # one wait, on the last event
    pass_sid = recs[-1]["sid"]
    assert all(r["parent"] == pass_sid for r in recs if r["name"] in ("io_wait", "chunk"))
    rep = treport.analyze(str(tmp_path / "t"))
    assert rep["processes"][str(os.getpid())]["phases"]["chunk"]["device_s"] == 0.0045
    assert tchrome.convert(recs)["traceEvents"][1]["args"]["device_s"] == 0.0015


def test_a_top_level_device_span_resolves_at_its_own_exit(fake_events, tmp_path):
    with obs.device_span("chunk", torch.device("cuda"), chunk=0):
        pass
    (rec,) = _records(tmp_path)
    assert rec["device_s"] == 0.0015 and len(_Event.synced) == 1


def test_an_unresolvable_device_span_raises_and_is_not_written(fake_events, tmp_path):
    _Event.broken = True
    with pytest.raises(RuntimeError, match="cannot be resolved"):
        with obs.span("pass"):
            with obs.device_span("chunk", torch.device("cuda")):
                pass
    assert not [r for r in _records(tmp_path) if r["name"] == "chunk"]


def test_a_device_span_keeps_the_context_it_ended_in(fake_events, tmp_path, monkeypatch):
    """Resolved at the pass exit, a record carries the context its span
    ended in, and the process's context (other threads read it) is not
    touched meanwhile."""
    seen = []
    open_fd = ttrace._fd
    monkeypatch.setattr(ttrace, "_fd", lambda d: seen.append(dict(ttrace._CTX)) or open_fd(d))
    prev = obs.set_context(role="worker000")
    try:
        with obs.span("pass"):
            with obs.device_span("chunk", torch.device("cuda")):
                pass
            obs.set_context(role="coordinator")
    finally:
        obs.set_context(**prev)
    chunk, pas = _records(tmp_path)
    assert (chunk["name"], chunk["ctx"]["role"]) == ("chunk", "worker000")
    assert (pas["name"], pas["ctx"]["role"]) == ("pass", "coordinator")
    assert [c["role"] for c in seen] == ["coordinator", "coordinator"]


def test_device_span_off_the_card_and_with_tracing_off(fake_events, tmp_path, monkeypatch):
    with obs.device_span("chunk", torch.device("cpu")):
        pass
    (rec,) = _records(tmp_path)
    assert "device_s" not in rec and not fake_events
    monkeypatch.delenv("RCCA_TRACE")
    with obs.device_span("chunk", torch.device("cuda")) as sp:
        assert sp is obs.span("anything")  # the shared null span
    assert not fake_events and len(_records(tmp_path)) == 1


# --------------------------------------------------------------------------
# the launchers and the CLI
# --------------------------------------------------------------------------


def test_cca_fit_trace_prints_its_report_and_exports(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("RCCA_TRACE", raising=False)
    trace_dir = str(tmp_path / "t")
    cca_fit.main(["--smoke", "--device", "cpu", "--trace", trace_dir])
    out = capsys.readouterr().out
    assert f"[cca] tracing -> {trace_dir}/" in out
    assert "span coverage (min over processes): 100.0%" in out
    assert "power/kernels" in out and "final/kernels" in out
    from repro_torch.obs.__main__ import main as obs_main

    assert obs_main(["export-trace", trace_dir, "-o", str(tmp_path / "t.json")]) == 0
    doc = json.load(open(tmp_path / "t.json"))
    spans = [ev for ev in ttrace.load_events(trace_dir) if ev["ev"] == "span"]
    assert len([e for e in doc["traceEvents"] if e["ph"] == "X"]) == len(spans)
    assert obs_main(["report", trace_dir, "--json", str(tmp_path / "r.json")]) == 0
    assert json.load(open(tmp_path / "r.json"))["coverage"] == 1.0
    assert obs_main(["trajectory"]) == 2
    assert "ROADMAP" in capsys.readouterr().out


def test_cca_serve_trace_records_the_serving_tier(tmp_path, monkeypatch):
    monkeypatch.delenv("RCCA_TRACE", raising=False)
    trace_dir = str(tmp_path / "t")
    rep = cca_serve.serve(cca_serve.parse_args(
        ["--smoke", "--device", "cpu", "--store", str(tmp_path / "store"), "--registry",
         str(tmp_path / "reg"), "--trace", trace_dir]))
    events = ttrace.load_events(trace_dir)
    spans = [ev for ev in events if ev["ev"] == "span"]
    ctrs = [ev for ev in events if ev["ev"] == "ctr"]

    def named(recs, name):
        return [ev for ev in recs if ev["name"] == name]

    assert len(named(spans, "delta_refit")) == 1
    assert len(named(spans, "index_build")) == 1
    assert sum(ev["attrs"]["occupancy"] for ev in named(spans, "serve_batch")) == \
        rep["projector"]["requests"]
    assert sum(ev["fields"]["occupancy"] for ev in named(ctrs, "serve_occupancy")) == \
        rep["projector"]["requests"]
    assert len(named(ctrs, "serve_swap")) == rep["projector"]["swaps"] >= 1
    assert [ev["fields"]["version"] for ev in named(ctrs, "registry_publish")] == [1, 2]
    assert len(named(ctrs, "drift")) >= 3
    (signal,) = named(ctrs, "drift_signal")
    assert signal["fields"]["ratio"] < 0.8
    delta = named(spans, "delta_refit")[0]
    inside = [ev for ev in spans if ev["parent"] == delta["sid"]]
    assert {ev["name"] for ev in inside} == {"io_wait", "chunk"}


# --------------------------------------------------------------------------
# the protocol checker
# --------------------------------------------------------------------------

P = "cl/partials/p00000_g00001"
PROTOCOL_CASES = {
    "clean": [{"op": "stage_write", "path": P + ".stage7"}, {"op": "commit", "path": P},
              {"op": "read", "path": P},
              {"op": "merge", "path": P, "meta": {"fit_id": "f", "pass_idx": 0, "group": 1}}],
    "RCCA201": [{"op": "commit", "path": P + ".stage7"}, {"op": "read", "path": P + ".stage7"}],
    "RCCA202": [{"op": "merge", "path": P, "meta": {"fit_id": "f", "pass_idx": 0, "group": 1}},
                {"op": "merge", "path": P, "meta": {"fit_id": "f", "pass_idx": 0, "group": 1}}],
    "RCCA203": [{"op": "commit", "path": P + "x"}, {"op": "read", "path": P}],
    "RCCA204": [{"op": "stale_replace", "path": P,
                 "meta": {"old_binding": {"fit_id": "f"}, "new_binding": {"fit_id": "f"}}},
                {"op": "stale_replace", "path": P,
                 "meta": {"old_binding": {"fit_id": "e"}, "new_binding": {"fit_id": "f"}}}],
}


@pytest.mark.parametrize("case", list(PROTOCOL_CASES))
def test_check_trace_matches_the_reference(case):
    events = PROTOCOL_CASES[case]
    got = tprotocol.check_trace(events, where="t")
    assert [str(v) for v in got] == [str(v) for v in jprotocol.check_trace(events, where="t")]
    assert [v.render() for v in got] == [v.render() for v in
                                         jprotocol.check_trace(events, where="t")]
    assert [v.code for v in got] == ([] if case == "clean" else [case])


def test_trace_event_records_and_mirrors(tmp_path, monkeypatch):
    monkeypatch.delenv("RCCA_TRACE", raising=False)
    monkeypatch.chdir(tmp_path)
    tprotocol.trace_event("commit", P)  # tracing off: nothing, nowhere
    assert os.listdir(tmp_path) == []
    monkeypatch.setenv("RCCA_TRACE", str(tmp_path / "t"))
    tprotocol.trace_event("commit", P, group=1)
    tprotocol.trace_event("read", P, group=1)
    mirrored = ttrace.load_events(str(tmp_path / "t"))
    assert [(e["ev"], e["op"], e["meta"]) for e in mirrored] == \
        [("proto", "commit", {"group": 1}), ("proto", "read", {"group": 1})]
    assert treport.analyze(str(tmp_path / "t"))["protocol"] == {"events": 2, "violations": []}
