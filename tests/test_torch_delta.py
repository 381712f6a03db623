"""Incremental delta-refits of the port (``repro_torch.exec.delta``).

Inside the port the contracts are the reference's, bitwise: an exact
``delta_refit`` of ``fit_with_state`` over chunks [0, 8) against the
store grown to 12 chunks is the cold fit of the grown store, for both
engines and every Ω mode; refits chain; a frozen refit leaves an exact
pass-0 state behind; no delta re-finalizes to the fit; q = 0 never
re-reads the old corpus.  Against the reference (``repro.exec.delta``,
the same Ω from the same seed under ``seeded-materialized``), ρ agrees
within 1e-5 relative, and a FitState written by either package loads in
the other and refits to the same ρ within that tolerance.  Sizes are the
reference's tests' (28 × 20 features, chunks of 128, merge groups of 2,
k = 4, p = 8, q = 1, centered); everything runs on the CPU.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core.rcca import RCCAConfig as JConfig
from repro.exec import FitState as JFitState
from repro.exec import delta_refit as j_delta_refit
from repro.exec import fit_with_state as j_fit_with_state
from repro.store import ViewStoreReader as JReader
from repro_torch.core.rcca import RCCAConfig
from repro_torch.data import PlantedCCAData
from repro_torch.exec import (Cluster, FitState, Local, Sharded, delta_refit, fit,
                              fit_with_state)
from repro_torch.exec.delta import FITSTATE_VERSION
from repro_torch.store import ViewStoreReader, extend_chunks, ingest_chunks

N0, N1, DA, DB, CHUNK = 1024, 1536, 28, 20, 128  # an 8-chunk prefix, 12 chunks in all
G = 2  # merge group: chunk·G = 256 divides N0, the alignment contract
CFG = RCCAConfig(k=4, p=8, q=1, nu=0.01, center=True)
JCFG = JConfig(k=4, p=8, q=1, nu=0.01, center=True)
SEED = 5
C0, C1 = N0 // CHUNK, N1 // CHUNK
RHO_RTOL = 1e-5  # the port against the reference: f32 sums in other orders
OMEGAS = ("materialized", "seeded", "seeded-materialized")


@pytest.fixture(scope="module")
def data():
    return PlantedCCAData(n=N1 + 512, da=DA, db=DB, rank=5, noise=0.4, seed=11, chunk=CHUNK)


def _chunks(data, lo, hi):
    for i in range(lo, hi):
        a, b = data.get_chunk(i)
        yield a.astype(np.float32), b.astype(np.float32)


def _ingest(path, data, lo, hi):
    return ingest_chunks(path, _chunks(data, lo, hi), chunk=CHUNK)


@pytest.fixture(scope="module")
def old_store(tmp_path_factory, data):
    return _ingest(str(tmp_path_factory.mktemp("tdelta") / "old"), data, 0, C0)


@pytest.fixture(scope="module")
def grown_store(tmp_path_factory, data):
    """Chunks [0, C0) ingested, then [C0, C1) appended."""
    path = str(tmp_path_factory.mktemp("tdelta") / "grown")
    _ingest(path, data, 0, C0)
    return extend_chunks(path, _chunks(data, C0, C1))


@pytest.fixture(scope="module")
def cold(grown_store):
    cache = {}

    def get(engine, omega="materialized", cfg=CFG):
        key = (engine, omega, cfg)
        if key not in cache:
            cache[key] = fit(grown_store, cfg, SEED, engine=engine, omega=omega,
                             merge_group=G, device="cpu")
        return cache[key]

    return get


@pytest.fixture(scope="module")
def fit_old(old_store):
    """(result, FitState) of the stateful prefix fit: kernels engine."""
    return fit_with_state(old_store, CFG, SEED, merge_group=G, device="cpu")


def _same(r1, r2):
    for f in ("Xa", "Xb", "rho", "Qa", "Qb"):
        assert torch.equal(getattr(r1, f), getattr(r2, f)), f"{f} differs"


def _rho_close(port, ref):
    np.testing.assert_allclose(port.rho.numpy(), np.asarray(ref.rho), rtol=RHO_RTOL, atol=0)


# -- exact refits: the bitwise-parity contract --------------------------------


@pytest.mark.parametrize("omega", OMEGAS)
@pytest.mark.parametrize("engine", ["kernels", "torch"])
def test_delta_refit_bitwise_parity(old_store, grown_store, cold, engine, omega):
    """fit(0..m) ≡ delta_refit(fit_with_state(0..n), store 0..m), and
    fit_with_state ≡ exec.fit on its own store."""
    res0, state = fit_with_state(old_store, CFG, SEED, merge_group=G, engine=engine,
                                 omega=omega, device="cpu")
    _same(res0, fit(old_store, CFG, SEED, engine=engine, omega=omega, merge_group=G,
                    device="cpu"))
    res, state2 = delta_refit(state, grown_store, device="cpu")
    _same(res, cold(engine, omega))
    d = res.diagnostics["delta"]
    assert (d["mode"], d["delta_chunks"], d["refolded_chunks"]) == ("exact", C1 - C0,
                                                                   C1 - C0 + C1)
    assert [p["chunks"] for p in d["passes"]] == [C1 - C0, C1]
    assert state2.meta["n"] == N1 and state2.meta["omega"] == omega
    assert state2.meta["engine"] == engine
    seeds = engine == "kernels" and omega == "seeded"
    assert isinstance(state.passes[0].Qa, tuple) == seeds


def test_delta_refit_chains(cold, tmp_path, data):
    """0..8 → +2 chunks → +2 chunks lands bitwise on the cold fit of all
    12: the persisted accumulators stay the canonical tree at every step
    (and the shard layout of the grown-in-place store differs from the
    cold store's)."""
    path = str(tmp_path / "chain")
    _ingest(path, data, 0, C0)
    _, state = fit_with_state(ViewStoreReader(path), CFG, SEED, merge_group=G, device="cpu")
    extend_chunks(path, _chunks(data, C0, 10))
    _, state = delta_refit(state, ViewStoreReader(path), device="cpu")
    extend_chunks(path, _chunks(data, 10, C1))
    res, _ = delta_refit(state, ViewStoreReader(path), device="cpu")
    _same(res, cold("kernels"))


@pytest.mark.parametrize("omega", ["materialized", "seeded"])
def test_frozen_then_exact_is_the_cold_fit(cold, tmp_path, data, omega):
    """Frozen mode folds only the delta (close to, not bitwise, the cold
    fit); its state keeps pass 0 exact, so an exact refit from it — after
    a save/load — is the cold fit bitwise."""
    path = str(tmp_path / "frozen")
    _ingest(path, data, 0, C0)
    _, state = fit_with_state(ViewStoreReader(path), CFG, SEED, merge_group=G, omega=omega,
                              device="cpu")
    extend_chunks(path, _chunks(data, C0, 10))
    res_f, state_f = delta_refit(state, ViewStoreReader(path), mode="frozen", device="cpu")
    d = res_f.diagnostics["delta"]
    assert (d["mode"], d["delta_chunks"], d["refolded_chunks"]) == ("frozen", 2, 2)
    twin = fit(ViewStoreReader(path), CFG, SEED, omega=omega, merge_group=G, device="cpu")
    np.testing.assert_allclose(np.sort(res_f.rho.numpy()), np.sort(twin.rho.numpy()),
                               atol=0.05)
    state_f.save(str(tmp_path / "fs"))
    extend_chunks(path, _chunks(data, 10, C1))
    res, _ = delta_refit(FitState.load(str(tmp_path / "fs")), ViewStoreReader(path),
                         device="cpu")
    _same(res, cold("kernels", omega))


def test_delta_refit_no_delta_refinalizes(fit_old, old_store):
    res0, state = fit_old
    res, state2 = delta_refit(state, old_store, device="cpu")
    _same(res, res0)
    assert res.diagnostics["delta"]["delta_chunks"] == 0 and state2 is state


@pytest.mark.parametrize("omega", ["materialized", "seeded"])
@pytest.mark.parametrize("mode", ["exact", "frozen"])
def test_q0_refit_folds_only_the_delta(old_store, grown_store, cold, mode, omega):
    """q = 0: the persisted pass is the final one; the refit folds the
    delta only (frozen degenerates to exact) and is the cold fit."""
    cfg = RCCAConfig(k=4, p=8, q=0, nu=0.01, center=True)
    _, state = fit_with_state(old_store, cfg, SEED, merge_group=G, omega=omega, device="cpu")
    assert list(state.passes) == [0] and state.passes[0].kind == "final"
    res, state2 = delta_refit(state, grown_store, mode=mode, device="cpu")
    _same(res, cold("kernels", omega, cfg))
    d = res.diagnostics["delta"]
    assert (d["mode"], d["refolded_chunks"]) == ("exact", C1 - C0)
    assert list(state2.passes) == [0]


def test_delta_refit_rejects_non_append_stores(fit_old, old_store, grown_store, tmp_path):
    _, state = fit_old
    other = PlantedCCAData(n=N1, da=DA, db=DB, rank=5, noise=0.4, seed=99, chunk=CHUNK)
    impostor = _ingest(str(tmp_path / "impostor"), other, 0, C1)
    with pytest.raises(ValueError, match="not an append"):
        delta_refit(state, impostor, device="cpu")
    narrow = PlantedCCAData(n=N0, da=DA - 4, db=DB, rank=5, noise=0.4, seed=11, chunk=CHUNK)
    skewed = _ingest(str(tmp_path / "skewed"), narrow, 0, C0)
    with pytest.raises(ValueError, match="geometry"):
        delta_refit(state, skewed, device="cpu")
    _, full_state = fit_with_state(grown_store, CFG, SEED, merge_group=G, device="cpu")
    with pytest.raises(ValueError, match="not an append"):
        delta_refit(full_state, old_store, device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        delta_refit(state, grown_store, mode="lazy", device="cpu")


def test_delta_refit_rejects_unaligned_old_corpus(tmp_path, data):
    """The fitted corpus must end on a merge-group boundary, or its last
    group's sum would straddle old and new rows; with no delta, a ragged
    corpus re-finalizes."""
    ragged = str(tmp_path / "ragged")  # 7 chunks: 896 % (128·2) != 0
    _ingest(ragged, data, 0, 7)
    res7, state = fit_with_state(ViewStoreReader(ragged), CFG, SEED, merge_group=G,
                                 device="cpu")
    _same(delta_refit(state, ViewStoreReader(ragged), device="cpu")[0], res7)
    extend_chunks(ragged, _chunks(data, 7, 9))
    with pytest.raises(ValueError, match="merge-group boundary"):
        delta_refit(state, ViewStoreReader(ragged), device="cpu")


def test_fitstate_save_load_roundtrip(fit_old, grown_store, tmp_path):
    """The disk round trip is lossless: same meta, the seeds as the
    reference's (2,)-uint32 leaves, no open-group leaves (or a zero group
    with ``zero_open_group``), and a refit from either copy is bitwise
    the refit from memory."""
    res0, state = fit_old
    r_mem, _ = delta_refit(state, grown_store, device="cpu")
    for zero in (False, True):
        d = str(tmp_path / f"fitstate_{zero}")
        nbytes = state.save(d, zero_open_group=zero)
        assert nbytes > 0
        loaded = FitState.load(d)
        for k, v in state.meta.items():
            assert loaded.meta[k] == v, k
        leaves = json.load(open(os.path.join(d, "manifest.json")))["leaves"]
        assert any("/current/" in k for k in leaves) == zero
        assert loaded.passes[0].acc_current is None or zero
        _same(delta_refit(loaded, grown_store, device="cpu")[0], r_mem)
    _, sstate = fit_with_state(ViewStoreReader(grown_store.path), CFG, SEED, merge_group=G,
                               omega="seeded", device="cpu")
    sstate.save(str(tmp_path / "seeded"))
    leaves = json.load(open(os.path.join(tmp_path, "seeded", "manifest.json")))["leaves"]
    assert leaves["p00000/Qa"]["dtype"] == "uint32" and leaves["p00000/Qa"]["shape"] == [2]
    loaded = FitState.load(str(tmp_path / "seeded"))
    assert loaded.passes[0].Qa == sstate.passes[0].Qa
    assert loaded.meta["version"] == FITSTATE_VERSION
    with pytest.raises(FileNotFoundError, match="no FitState"):
        FitState.load(str(tmp_path / "nothing"))


@pytest.mark.parametrize("topology", [Sharded(), "sharded", Cluster(2), "cluster", "hybrid"])
def test_topologies_other_than_local_are_rejected(fit_old, old_store, grown_store, topology):
    """Local and Sharded capture and refit (the Sharded pair bitwise the
    Local one: tests/test_torch_topologies.py holds more); Cluster and
    Hybrid are rejected, as the reference rejects them."""
    res_old, state = fit_old
    name = topology if isinstance(topology, str) else topology.name
    want = delta_refit(state, grown_store, topology=Local(), device="cpu")[0]
    if name == "sharded":
        res, sstate = fit_with_state(old_store, CFG, SEED, topology=topology, device="cpu",
                                     merge_group=G)
        _same(res, res_old)
        _same(delta_refit(sstate, grown_store, topology=topology, device="cpu")[0], want)
        return
    with pytest.raises(ValueError, match="Local and Sharded"):
        fit_with_state(old_store, CFG, SEED, topology=topology, device="cpu")
    with pytest.raises(ValueError, match="Local and Sharded"):
        delta_refit(state, grown_store, topology=topology, device="cpu")


# -- against the reference -----------------------------------------------------


@pytest.fixture(scope="module")
def j_stores(old_store, grown_store):
    """The reference's readers over the port's stores (one format)."""
    return JReader(old_store.path), JReader(grown_store.path)


def test_fit_with_state_and_delta_match_reference(old_store, grown_store, j_stores):
    """The same Ω from the same seed (``seeded-materialized``): the port's
    kernels-engine fit_with_state and exact delta refit against the
    reference's jnp-engine ones, ρ within 1e-5 relative."""
    j_old, j_grown = j_stores
    j_res0, j_state = j_fit_with_state(j_old, JCFG, jax.random.PRNGKey(SEED), merge_group=G,
                                       engine="jnp", omega="seeded-materialized")
    j_res, _ = j_delta_refit(j_state, j_grown)
    res0, state = fit_with_state(old_store, CFG, SEED, merge_group=G,
                                 omega="seeded-materialized", device="cpu")
    res, _ = delta_refit(state, grown_store, device="cpu")
    _rho_close(res0, j_res0)
    _rho_close(res, j_res)
    for k in ("fingerprint", "n", "shards", "merge_group", "algo", "omega"):
        assert state.meta[k] == j_state.meta[k], k


def test_reference_fitstate_loads_in_the_port(j_stores, grown_store, tmp_path):
    """A FitState the reference wrote (kernels engine, seeded: its pass 0
    holds (2,)-uint32 seeds and a zero open group) loads in the port and
    refits to the reference's ρ."""
    j_old, j_grown = j_stores
    _, j_state = j_fit_with_state(j_old, JCFG, jax.random.PRNGKey(SEED), merge_group=G,
                                  engine="kernels", omega="seeded")
    j_res, _ = j_delta_refit(j_state, j_grown)
    d = str(tmp_path / "j_state")
    j_state.save(d)
    state = FitState.load(d)
    assert state.passes[0].Qa == tuple(int(v) for v in np.asarray(j_state.passes[0].Qa))
    assert state.passes[0].acc_current is not None  # the reference's zero group
    res, _ = delta_refit(state, grown_store, device="cpu")
    _rho_close(res, j_res)


def test_port_fitstate_loads_in_the_reference(fit_old, j_stores, tmp_path):
    """A FitState the port wrote (with the zero open group the
    reference's loader reads) loads in the reference, with its seeds and
    stacks bit for bit, and refits there to the port's ρ."""
    j_old, j_grown = j_stores
    res0, state = fit_with_state(ViewStoreReader(j_old.path), CFG, SEED, merge_group=G,
                                 omega="seeded", device="cpu")
    d = str(tmp_path / "t_state")
    state.save(d, zero_open_group=True)
    j_state = JFitState.load(d)
    assert tuple(int(v) for v in np.asarray(j_state.passes[0].Qa)) == state.passes[0].Qa
    np.testing.assert_array_equal(np.asarray(j_state.passes[0].acc_stack[0].Ya),
                                  state.passes[0].acc_stack[0].Ya.numpy())
    j_res, _ = j_delta_refit(j_state, j_grown)
    res, _ = delta_refit(state, ViewStoreReader(j_grown.path), device="cpu")
    _rho_close(res, j_res)
