"""The port's cluster-protocol race detector: trace invariants (RCCA201-204)
against the reference's checker, live recording through the port's
partial store into ``$RCCA_PROTOCOL_TRACE`` (a broken atomic rename the
checker must catch), and the small-model interleaving explorer (RCCA205)
against the reference's: 5 crash scenarios, 42 interleavings, the same
two injected bugs caught.
"""

import numpy as np
import pytest
import torch

from repro.analysis import protocol as jprotocol
from repro_torch.analysis import protocol
from repro_torch.cluster import partials
from repro_torch.core import rcca as tr
from repro_torch.data import PlantedCCAData
from repro_torch.exec import Cluster, fit
from repro_torch.store import ingest_planted


def codes(violations):
    return sorted(v.code for v in violations)


# ---------------------------------------------------------------------------
# offline invariant checking over synthetic traces
# ---------------------------------------------------------------------------


def ev(op, path, **meta):
    e = {"op": op, "path": path, "pid": 1}
    if meta:
        e["meta"] = meta
    return e


GOOD_TRACE = [
    ev("stage_write", "/c/pass0/partial_0.stage7", group=0),
    ev("commit", "/c/pass0/partial_0", group=0),
    ev("read", "/c/pass0/partial_0", group=0),
    ev("merge", "/c/pass0/partial_0", fit_id="f", pass_idx=0, group=0),
    ev("merge", "/c/pass0/partial_1", fit_id="f", pass_idx=0, group=1),
    ev("merge", "/c/pass1/partial_0", fit_id="f", pass_idx=1, group=0),
]
_B = {"fit_id": "f", "pass_idx": 0}
BAD_TRACES = {
    "RCCA201": GOOD_TRACE + [ev("read", "/c/pass0/partial_0.stage7", group=0)],
    "RCCA202": GOOD_TRACE + [ev("merge", "/c/pass0/partial_1", fit_id="f", pass_idx=0,
                                group=1)],
    "RCCA203": [ev("read", "/c/pass0/partial_0", group=0)],
    "RCCA204": [ev("stale_replace", "/c/p", old_binding=_B, new_binding=dict(_B))],
}


def test_clean_trace_passes():
    assert protocol.check_trace(GOOD_TRACE) == []


@pytest.mark.parametrize("code", sorted(BAD_TRACES))
def test_each_invariant_trips_as_in_the_reference(code):
    vs = protocol.check_trace(BAD_TRACES[code])
    assert codes(vs) == [code]
    assert [v.render() for v in vs] == [v.render() for v in
                                        jprotocol.check_trace(BAD_TRACES[code])]


def test_rcca202_and_204_other_fits_and_bindings_pass():
    ok = GOOD_TRACE + [ev("merge", "/x", fit_id="f2", pass_idx=0, group=1),
                       ev("merge", "/y", fit_id="f", pass_idx=2, group=1),
                       ev("stale_replace", "/c/p", old_binding=_B,
                          new_binding={"fit_id": "g", "pass_idx": 0})]
    assert protocol.check_trace(ok) == []


def test_check_trace_file_missing_is_clean(tmp_path, monkeypatch):
    monkeypatch.delenv(protocol.TRACE_ENV, raising=False)
    assert protocol.check_trace_file() == []
    assert protocol.check_trace_file(str(tmp_path / "nope.jsonl")) == []


# ---------------------------------------------------------------------------
# live recording through the port's partial store
# ---------------------------------------------------------------------------


def _stats(val=1.0):
    z = tr.stats_init_fn("final", 3, 3, 2, "cpu")()
    return z._replace(n=torch.tensor(val))


def _meta(fit_id="fit-a", pass_idx=0):
    return partials.binding_meta(fit_id=fit_id, pass_idx=pass_idx, kind="final",
                                 engine="torch", fingerprint="fp", merge_group=8,
                                 algo={"k": 2})


@pytest.fixture
def traced(tmp_path, monkeypatch):
    trace = str(tmp_path / "trace.jsonl")
    monkeypatch.setenv(protocol.TRACE_ENV, trace)
    monkeypatch.delenv("RCCA_TRACE", raising=False)
    return trace


def test_trace_event_roundtrip(traced):
    protocol.trace_event("commit", "/a/b", group=3)
    protocol.trace_event("read", "/a/b")
    events = protocol.read_trace(traced)
    assert [e["op"] for e in events] == ["commit", "read"]
    assert events[0]["meta"]["group"] == 3 and events[0]["path"] == "/a/b"
    assert protocol.check_trace_file(traced) == []


def test_trace_event_noop_when_unset(tmp_path, monkeypatch):
    monkeypatch.delenv(protocol.TRACE_ENV, raising=False)
    monkeypatch.delenv("RCCA_TRACE", raising=False)
    protocol.trace_event("commit", "/a/b")
    assert list(tmp_path.iterdir()) == []


def test_real_write_read_partial_trace_is_clean(tmp_path, traced):
    cdir = str(tmp_path / "cluster")
    partials.write_partial(cdir, 0, 0, _stats(), _meta(), shard=0, n_shards=1)
    assert partials.read_partial(cdir, 0, 0) is not None
    events = protocol.read_trace(traced)
    assert [e["op"] for e in events] == ["stage_write", "commit", "read"]
    assert protocol.check_trace(events) == []


def test_broken_atomic_rename_injection_is_caught(tmp_path, traced):
    """A writer that skips the staging and rename: the partial appears and
    the read succeeds, but the trace has no commit, the torn-write
    signature RCCA203 exists for."""
    from repro_torch.ckpt import save_pytree

    cdir = str(tmp_path / "cluster")
    final = partials.partial_path(cdir, 0, 0)
    save_pytree(_stats()._asdict(), final,
                metadata={**_meta(), "group": 0, "span": 1, "shard": 0, "n_shards": 1})
    assert partials.read_partial(cdir, 0, 0) is not None  # the reader cannot tell
    assert codes(protocol.check_trace_file(traced)) == ["RCCA203"]  # the trace can


def test_stale_replace_records_both_bindings(tmp_path, traced):
    cdir = str(tmp_path / "cluster")
    partials.write_partial(cdir, 0, 0, _stats(), _meta(fit_id="fit-a"), shard=0, n_shards=1)
    partials.write_partial(cdir, 0, 0, _stats(2.0), _meta(fit_id="fit-b"), shard=0,
                           n_shards=1)
    events = protocol.read_trace(traced)
    sr = next(e for e in events if e["op"] == "stale_replace")
    assert sr["meta"]["old_binding"]["fit_id"] == "fit-a"
    assert sr["meta"]["new_binding"]["fit_id"] == "fit-b"
    assert protocol.check_trace(events) == []


# ---------------------------------------------------------------------------
# small-model interleaving exploration (RCCA205)
# ---------------------------------------------------------------------------


def test_explorer_covers_all_orderings_as_the_reference():
    """2 workers × 4 groups: the fault-free run and every crash point,
    every interleaving, each merge bitwise the canonical tree."""
    rep = protocol.explore_interleavings(n_workers=2, n_groups=4)
    ref = jprotocol.explore_interleavings(n_workers=2, n_groups=4)
    assert rep.ok and rep.violations() == []
    assert (rep.n_scenarios, rep.n_interleavings) == (5, 42)
    assert (ref.n_scenarios, ref.n_interleavings) == (5, 42)


def test_explorer_payloads_match_the_reference_and_are_order_sensitive():
    for g in range(4):
        mine, ref = protocol._group_payload(g), jprotocol._group_payload(g)
        assert mine.y.numpy().tobytes() == np.asarray(ref["y"]).tobytes()
        assert mine.n.numpy().tobytes() == np.asarray(ref["n"]).tobytes()
    a, b, c = (protocol._group_payload(g).y for g in range(3))
    assert bool(((a + b) + c != a + (b + c)).any())


@pytest.mark.parametrize("mutate", ["arrival_order", "torn_publish"])
def test_explorer_detects_each_injected_bug_as_the_reference(mutate):
    rep = protocol.explore_interleavings(mutate=mutate)
    ref = jprotocol.explore_interleavings(mutate=mutate)
    assert not rep.ok and all(v.code == "RCCA205" for v in rep.violations())
    assert len(rep.mismatches) == len(ref.mismatches)


def test_explorer_rejects_large_models():
    with pytest.raises(ValueError):
        protocol.explore_interleavings(n_workers=3, n_groups=4)
    with pytest.raises(ValueError):
        protocol.explore_interleavings(n_groups=9)


# ---------------------------------------------------------------------------
# end to end: a two-worker cluster fit leaves a clean protocol file
# ---------------------------------------------------------------------------


def test_cluster_fit_protocol_file_is_clean(tmp_path, traced):
    data = PlantedCCAData(n=512, da=8, db=6, rank=3, noise=0.4, seed=11, chunk=64)
    store = ingest_planted(str(tmp_path / "store"), data)
    res = fit(store, tr.RCCAConfig(k=2, p=2, q=1), 0, topology=Cluster(n_workers=2),
              merge_group=2, cluster_dir=str(tmp_path / "cluster"), device="cpu",
              worker_timeout=240)
    assert res.rho.shape == (2,)
    events = protocol.read_trace(traced)
    assert {"stage_write", "commit", "read", "merge"} <= {e["op"] for e in events}
    assert len({e["pid"] for e in events}) >= 3  # the workers' events reach the file
    assert sum(e["op"] == "merge" for e in events) == 2 * 4
    assert protocol.check_trace(events) == []
