"""The serving tier of the port (``repro_torch.serve``, ``cca_serve``).

- The registry keeps the reference's layout and hash: a version either
  package publishes loads in the other with its content hash verified;
  rollback, pruning (never the current version or its parent, safe under
  concurrent readers) and corruption detection as the reference's.
- The projector coalesces concurrent requests into padded batches and
  hot-swaps at a batch boundary with zero drops and no mixed versions.
  On the CPU both engines take the plain product, whose bits may move
  with the batch size, so a response is held to its stamped version's
  product of the row alone within 1e-6 relative, and shown outside that
  of the other version; the bitwise form (``project_rows``: fixed
  segments of K, each an FMA chain, combined by one tree whose shape
  depends on K alone) is held on the card by ``chip_smoke.py``'s serve
  phase.
- The corpus index, the drift monitor and ``paired_correlation`` behave
  as the reference's, and are held to ``repro.serve``'s on the same
  model and rows: ``paired_correlation`` and the monitor's window means
  within REF_RTOL, the index's top-k rows equal and its scores within
  REF_RTOL; ``cca_serve --smoke --device cpu`` runs its loop.
"""

import os
import threading
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro.serve import CorpusIndex as JCorpusIndex
from repro.serve import DriftMonitor as JDriftMonitor
from repro.serve import ModelRegistry as JRegistry
from repro.serve import ServedModel as JServedModel
from repro.serve.drift import paired_correlation as j_paired_correlation
from repro_torch.core.rcca import RCCAConfig
from repro_torch.data import PlantedCCAData
from repro_torch.exec import fit_with_state
from repro_torch.launch import cca_serve
from repro_torch.serve import (BatchedProjector, CorpusIndex, DriftMonitor, ModelRegistry,
                               ServedModel, paired_correlation, project)
from repro_torch.serve import projector as tprojector
from repro_torch.serve.registry import _content_hash
from repro_torch.store import extend_chunks, ingest_chunks

N0, N1, DA, DB, CHUNK = 1024, 1536, 28, 20, 128
G = 2
CFG = RCCAConfig(k=4, p=8, q=1, nu=0.01, center=True)
SEED = 5
C0, C1 = N0 // CHUNK, N1 // CHUNK
RTOL = 1e-6  # a batched row against the row alone, on the CPU's plain product
# the port against the reference on the same model and rows: two f32
# products of one shape from two libraries (torch, numpy or XLA), whose
# sums may be ordered differently — a few ulps in each embedding
REF_RTOL = 1e-5


@pytest.fixture(scope="module")
def data():
    # rows past chunk C1 never enter a store: held-out serving traffic
    return PlantedCCAData(n=N1 + 512, da=DA, db=DB, rank=5, noise=0.4, seed=11, chunk=CHUNK)


def _chunks(data, lo, hi):
    for i in range(lo, hi):
        a, b = data.get_chunk(i)
        yield a.astype(np.float32), b.astype(np.float32)


def _held_out(data, i=C1):
    a, b = data.get_chunk(i)
    return a.astype(np.float32), b.astype(np.float32)


@pytest.fixture(scope="module")
def stores(tmp_path_factory, data):
    root = tmp_path_factory.mktemp("tserve")
    old = ingest_chunks(str(root / "old"), _chunks(data, 0, C0), chunk=CHUNK)
    ingest_chunks(str(root / "grown"), _chunks(data, 0, C0), chunk=CHUNK)
    grown = extend_chunks(str(root / "grown"), _chunks(data, C0, C1))
    return old, grown


@pytest.fixture(scope="module")
def fits(stores):
    """(result, FitState) of the old store and of the grown store."""
    old, grown = stores
    return (fit_with_state(old, CFG, SEED, merge_group=G, device="cpu"),
            fit_with_state(grown, CFG, SEED, merge_group=G, device="cpu"))


def _model(res, version=1):
    return ServedModel(name="m", version=version, Xa=res.Xa, Xb=res.Xb, rho=res.rho,
                       Qa=res.Qa, Qb=res.Qb, meta={})


def _ref_model(res, version=1):
    """The reference's ``ServedModel`` of the same fit, as numpy arrays."""
    return JServedModel(name="m", version=version, meta={},
                        **{f: getattr(res, f).numpy() for f in ("Xa", "Xb", "rho", "Qa", "Qb")})


def _leaves_equal(m, res):
    for f in ("Xa", "Xb", "rho", "Qa", "Qb"):
        assert torch.equal(getattr(m, f), getattr(res, f)), f


# -- registry -------------------------------------------------------------------


def test_registry_publish_load_roundtrip(fits, tmp_path):
    (res1, st1), (res2, st2) = fits
    reg = ModelRegistry(str(tmp_path / "reg"))
    v1 = reg.publish("m", res1, fit_meta=st1.meta)
    v2 = reg.publish("m", res2, fit_meta=st2.meta)
    assert (v1, v2) == (1, 2) and reg.versions("m") == [1, 2] and reg.models() == ["m"]
    assert reg.current_version("m") == 2
    m2 = reg.load("m", device="cpu")
    assert m2.version == 2 and m2.k == CFG.k and m2.device.type == "cpu"
    _leaves_equal(m2, res2)
    _leaves_equal(reg.load("m", version=1, device="cpu"), res1)
    meta = reg.meta("m", 2)
    assert meta["parent"] == 1 and meta["fit"]["n"] == N1
    assert meta["fit"]["fingerprint"] == st2.meta["fingerprint"]
    assert set(meta["fit"]) == {"engine", "omega", "merge_group", "algo", "fingerprint", "n"}


def test_registry_rollback_and_bad_version(fits, tmp_path):
    (res1, _), (res2, _) = fits
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish("m", res1)
    reg.publish("m", res2)
    reg.set_current("m", 1)
    assert reg.load("m", device="cpu").version == 1
    with pytest.raises(ValueError, match="no published version"):
        reg.set_current("m", 7)
    with pytest.raises(ValueError, match="bad model name"):
        reg.publish("../x", res1)
    with pytest.raises(FileNotFoundError, match="no published versions"):
        reg.load("absent", device="cpu")


def test_registry_prune_keeps_current_and_rollback(fits, tmp_path):
    (res1, _), _ = fits
    reg = ModelRegistry(str(tmp_path / "reg"))
    for _ in range(6):
        reg.publish("m", res1)
    reg.set_current("m", 3)  # a rollback: current v3, its parent v2
    pruned = reg.prune("m", keep=2)
    assert pruned == [1, 4]
    assert reg.versions("m") == [2, 3, 5, 6]
    assert reg.load("m", device="cpu").version == 3
    with pytest.raises(ValueError, match="keep"):
        reg.prune("m", keep=0)
    assert not [d for d in os.listdir(tmp_path / "reg" / "m") if d.startswith(".trash")]


def test_registry_prune_safe_under_concurrent_readers(fits, tmp_path):
    (res1, _), _ = fits
    reg = ModelRegistry(str(tmp_path / "reg"))
    for _ in range(8):
        reg.publish("m", res1)
    errors = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            try:
                m = reg.load("m", version=2, device="cpu")  # a version prune removes
                assert m.version == 2
            except FileNotFoundError:
                pass  # pruned away between listing and open: a clean miss
            except Exception as e:  # noqa: BLE001 — anything else is torn
                errors.append(e)
                return

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        pruned = reg.prune("m", keep=1)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert 2 in pruned
    assert not errors, f"reader observed a torn artifact: {errors[0]!r}"
    assert reg.versions("m") == [7, 8]  # current v8, its parent v7, the newest 1
    reg.load("m", device="cpu")


def test_registry_detects_corrupted_artifact(fits, tmp_path):
    (res1, _), _ = fits
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish("m", res1)
    vdir = os.path.join(str(tmp_path / "reg"), "m", "v00001")
    (xa,) = [f for f in os.listdir(vdir) if f.startswith("Xa")]
    arr = np.load(os.path.join(vdir, xa)).copy()
    arr.flat[0] += 1.0
    np.save(os.path.join(vdir, xa), arr)
    with pytest.raises(ValueError, match="hash mismatch"):
        reg.load("m", device="cpu")


class _NumpyResult(NamedTuple):
    Xa: np.ndarray
    Xb: np.ndarray
    rho: np.ndarray
    Qa: np.ndarray
    Qb: np.ndarray


def test_registry_versions_load_across_packages(fits, tmp_path):
    """A version the reference publishes loads in the port, hash verified,
    and the reverse; both hash the same bytes to the same digest."""
    (res1, st1), (res2, _) = fits
    root = str(tmp_path / "reg")
    j_reg, t_reg = JRegistry(root), ModelRegistry(root)
    j_reg.publish("m", _NumpyResult(*(getattr(res1, f).numpy() for f in _NumpyResult._fields)))
    t_reg.publish("m", res2, fit_meta=st1.meta)
    assert t_reg.meta("m", 2)["parent"] == 1
    _leaves_equal(t_reg.load("m", version=1, device="cpu"), res1)
    m2 = j_reg.load("m", version=2)  # the reference verifies the port's hash
    np.testing.assert_array_equal(np.asarray(m2.Xa), res2.Xa.numpy())
    assert t_reg.meta("m", 1)["content_sha256"] == \
        _content_hash({f: getattr(res1, f) for f in _NumpyResult._fields})


# -- projector -------------------------------------------------------------------


def test_projector_validates_and_shuts_down(fits):
    (res1, _), _ = fits
    proj = BatchedProjector(_model(res1), max_batch=4)
    with pytest.raises(ValueError, match="view"):
        proj.submit("c", np.zeros(DA, np.float32))
    with pytest.raises(ValueError, match="features"):
        proj.submit("a", np.zeros(DA + 1, np.float32))
    assert proj.project_b(np.zeros(DB, np.float32))["emb"].shape == (CFG.k,)
    proj.close()
    with pytest.raises(RuntimeError, match="shut down"):
        proj.submit("a", np.zeros(DA, np.float32))
    with pytest.raises(ValueError, match="max_batch"):
        BatchedProjector(_model(res1), max_batch=0)
    with pytest.raises(ValueError, match="engine"):
        BatchedProjector(_model(res1), engine="jnp")


def test_projector_failed_batch_strands_no_ticket(fits, data, monkeypatch):
    """A batch whose projection raises completes every ticket with the
    error; the queue drains on close, and later batches still serve."""
    (res1, _), _ = fits
    xa, _ = _held_out(data)
    calls = {"n": 0}
    real = tprojector.project

    def flaky(X, x, engine):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("device fault")
        return real(X, x, engine)

    monkeypatch.setattr(tprojector, "project", flaky)
    proj = BatchedProjector(_model(res1), max_batch=8, max_wait_s=0.05)
    tickets = [proj.submit("a", xa[i]) for i in range(6)]
    errors = 0
    for t in tickets:
        try:
            t.result(timeout=30)
        except RuntimeError as e:
            assert "device fault" in str(e)
            errors += 1
    assert errors >= 1 and all(t.done() for t in tickets)
    late = [proj.submit("a", xa[i]) for i in range(5)]
    proj.close()
    assert [t.result(timeout=30)["version"] for t in late] == [1] * 5


@pytest.mark.parametrize("engine", ["kernels", "torch"])
def test_hot_swap_zero_drops_no_mixed_versions(fits, data, engine):
    """Requests across a version flip all complete, each stamped with one
    version: its embedding is that version's projection of the row alone
    (within RTOL on the CPU) and not the other version's."""
    (res1, _), (res2, _) = fits
    models = {1: _model(res1, 1), 2: _model(res2, 2)}
    xa, _ = _held_out(data)
    n_before = n_after = 24
    rows = [xa[i % CHUNK] for i in range(n_before + n_after)]
    with BatchedProjector(models[1], max_batch=8, engine=engine) as proj:
        before = [proj.submit("a", rows[i]) for i in range(n_before)]
        before[0].result(timeout=30)
        proj.swap(models[2])
        after = [proj.submit("a", rows[n_before + i]) for i in range(n_after)]
        results = [t.result(timeout=30.0) for t in before + after]
        stats = proj.stats()
    assert len(results) == n_before + n_after  # zero drops
    for i, r in enumerate(results):
        v = r["version"]
        assert v in (1, 2)
        want = project(models[v].Xa, rows[i][None], engine)[0].numpy()
        other = project(models[3 - v].Xa, rows[i][None], engine)[0].numpy()
        np.testing.assert_allclose(r["emb"], want, rtol=RTOL, atol=0)
        assert not np.allclose(r["emb"], other, rtol=RTOL, atol=0), (i, v)
    assert results[0]["version"] == 1
    assert all(t.result()["version"] == 2 for t in after)
    assert stats["requests"] == n_before + n_after and stats["swaps"] == 1
    assert stats["batches"] >= 1 and 1 <= stats["mean_occupancy"] <= 8


# -- corpus index, drift ---------------------------------------------------------------


def test_corpus_index_topk(fits, stores):
    _, (res, _) = fits
    model = _model(res)
    index = CorpusIndex.from_store(model, stores[1], view="b")
    assert index.emb.shape == (N1, CFG.k)
    a, _ = stores[1].get_chunk(0)
    q = model.project_a(a[3]).numpy()
    idx, scores = index.topk(q, k=10)
    assert idx.shape == scores.shape == (10,)
    assert np.all(np.diff(scores) <= 0)
    weighted = q.astype(np.float32) * res.rho.numpy()
    np.testing.assert_array_equal(scores, (index.emb @ weighted)[idx])
    pair = model.score(torch.from_numpy(q)[None], torch.from_numpy(index.emb[idx[:1]]))
    np.testing.assert_allclose(pair.numpy(), scores[:1], rtol=1e-6)
    assert CorpusIndex.from_store(model, stores[1], view="a", max_rows=300).emb.shape == \
        (300, CFG.k)
    with pytest.raises(ValueError, match="view"):
        CorpusIndex(model, "c", index.emb)


def test_drift_signal_and_recovery(fits, data):
    _, (res, _) = fits
    model = _model(res)
    fired = []
    mon = DriftMonitor(model, window=256, threshold=0.8, on_refit_needed=fired.append)
    xa, xb = (np.concatenate(v) for v in zip(*(_held_out(data, i) for i in (C1, C1 + 1))))
    assert mon.observe(xa[:128], xb[:128]) is None  # half a window
    base = mon.observe(xa[128:256], xb[128:256])
    assert mon.baseline == base and base > 0.5 and not mon.refit_needed
    perm = np.random.default_rng(7).permutation(256)
    shifted = mon.observe(xa[:256], xb[:256][perm])
    assert shifted < 0.8 * base and mon.refit_needed and fired == [mon]
    mon.observe(xa[:256], xb[:256][perm])
    assert fired == [mon]  # latched: one signal
    mon.rebind(model)
    assert not mon.refit_needed and mon.baseline is None
    recovered = mon.observe(xa[:256], xb[:256])
    assert recovered >= 0.8 * base
    assert mon.status()["windows"] == 4
    with pytest.raises(ValueError, match="paired"):
        mon.observe(xa[:3], xb[:4])
    with pytest.raises(ValueError, match="threshold"):
        DriftMonitor(model, threshold=1.5)


@pytest.mark.parametrize("engine", ["kernels", "torch"])
def test_corpus_index_matches_reference(fits, stores, engine):
    """The index of view b built by the port and by ``repro.serve`` from
    the same store and model: the same embeddings within REF_RTOL, and
    for queries from view a the same top-k rows, scores within REF_RTOL."""
    _, (res, _) = fits
    model, jmodel = _model(res), _ref_model(res)
    index = CorpusIndex.from_store(model, stores[1], view="b", engine=engine)
    jindex = JCorpusIndex.from_store(jmodel, stores[1].path, view="b")
    np.testing.assert_allclose(index.emb, jindex.emb, rtol=REF_RTOL, atol=1e-6)
    a, _ = stores[1].get_chunk(0)
    for row in (0, 3, 77):
        q = model.project_a(a[row], engine).numpy()
        idx, scores = index.topk(q, k=10)
        jidx, jscores = jindex.topk(q, k=10)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_allclose(scores, jscores, rtol=REF_RTOL, atol=1e-6)


@pytest.mark.parametrize("engine", ["kernels", "torch"])
def test_drift_monitor_matches_reference(fits, data, engine):
    """The port's monitor and ``repro.serve``'s, fed the same windows:
    baseline, the shifted window's mean, the latch and the rebound
    mean agree window by window (means within REF_RTOL)."""
    (res1, _), (res2, _) = fits
    xa, xb = (np.concatenate(v) for v in zip(*(_held_out(data, i) for i in (C1, C1 + 1))))
    perm = np.random.default_rng(7).permutation(256)
    mon = DriftMonitor(_model(res1), window=256, threshold=0.8, engine=engine)
    jmon = JDriftMonitor(_ref_model(res1), window=256, threshold=0.8)
    windows = [(xa[:128], xb[:128]), (xa[128:256], xb[128:256]), (xa[:256], xb[:256][perm]),
               "rebind", (xa[:256], xb[:256])]
    for w in windows:
        if w == "rebind":
            mon.rebind(_model(res2, 2))
            jmon.rebind(_ref_model(res2, 2))
        else:
            got, want = mon.observe(*w), jmon.observe(*w)
            assert (got is None) == (want is None)
            if want is not None:
                np.testing.assert_allclose(got, want, rtol=REF_RTOL)
        assert mon.refit_needed == jmon.refit_needed
        assert (mon.baseline is None) == (jmon.baseline is None)
        if jmon.baseline is not None:
            np.testing.assert_allclose(mon.baseline, jmon.baseline, rtol=REF_RTOL)
    st, jst = mon.status(), jmon.status()
    assert {k: st[k] for k in ("version", "refit_needed", "windows", "buffered")} == \
        {k: jst[k] for k in ("version", "refit_needed", "windows", "buffered")}


def test_paired_correlation_matches_reference(fits, stores, data):
    """``paired_correlation`` of the port and of ``repro.serve`` on the
    same model and rows (the fitted rows, held-out rows, and a broken
    pairing), per component within REF_RTOL."""
    _, (res, _) = fits
    model, jmodel = _model(res), _ref_model(res)
    a, b = (t.numpy() for t in stores[1].materialize())
    xa, xb = _held_out(data)
    perm = np.random.default_rng(3).permutation(xb.shape[0])
    for ra, rb in ((a, b), (xa, xb), (xa, xb[perm])):
        want = j_paired_correlation(jmodel, ra, rb)
        for engine in ("kernels", "torch"):
            np.testing.assert_allclose(paired_correlation(model, ra, rb, engine), want,
                                       rtol=REF_RTOL, atol=1e-6)


def test_paired_correlation_tracks_rho(fits, stores):
    """On the fitted rows the projections' per-component correlation is
    the fitted canonical correlations, up to the ridge."""
    _, (res, _) = fits
    a, b = (t.numpy() for t in stores[1].materialize())
    corr = paired_correlation(_model(res), a, b)
    np.testing.assert_allclose(corr, res.rho.numpy(), atol=0.02)
    for engine in ("kernels", "torch"):
        np.testing.assert_allclose(paired_correlation(_model(res), a, b, engine), corr,
                                   rtol=1e-5, atol=1e-6)


def test_cca_serve_cli_loop(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--store", str(tmp_path / "store"),
            "--registry", str(tmp_path / "reg"), "--prune-keep", "1"]
    assert cca_serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "refit_needed=True" in out
    assert "versions seen: [1, 2], dropped: 0" in out
    assert "post-swap held-out correlation" in out
    assert "versions [1, 2], current v2" in out
    rep = cca_serve.serve(cca_serve.parse_args(
        ["--smoke", "--device", "cpu", "--store", str(tmp_path / "store_t"),
         "--registry", str(tmp_path / "reg_t"), "--engine", "torch", "--omega", "seeded"]))
    assert rep["versions_seen"] == [1, 2] and rep["dropped"] == 0
    assert rep["delta"]["delta_chunks"] == C1 - C0 and rep["recovered"] >= 0.8 * rep["baseline"]
    # the Sharded fit and refit (three host slots): the local loop's numbers
    rep_s = cca_serve.serve(cca_serve.parse_args(
        ["--smoke", "--device", "cpu", "--store", str(tmp_path / "store_s"), "--registry",
         str(tmp_path / "reg_s"), "--topology", "sharded", "--devices", "3"]))
    rep_l = cca_serve.serve(cca_serve.parse_args(
        ["--smoke", "--device", "cpu", "--store", str(tmp_path / "store_l"), "--registry",
         str(tmp_path / "reg_l")]))
    assert rep_s["versions_seen"] == [1, 2] and rep_s["dropped"] == 0
    for key in ("sum_rho_v1", "sum_rho_v2"):
        assert rep_s[key] == rep_l[key], key
