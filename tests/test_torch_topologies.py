"""The streaming Sharded topology of the port, in process: merge groups
folded one per device slot, bitwise the Local fit.

The contract is the reference's (``tests/test_exec_topologies.py``):
whole merge groups are the only unit of distribution, each is left-folded
on one slot with the Local fold's per-chunk update, and the group sums
enter the same pairwise tree in the same order, so the tests assert
``torch.equal``.  Here the slots are host slots (``devices=n`` with
``device="cpu"``: the kernels' plain versions); on the card the same code
puts each slot on its own stream (``chip_smoke.py``).  Against the
reference's Local store fit (``repro.exec.fit``, jnp engine, the same Ω
fed as numpy) ρ agrees within 1e-5 relative.  The Hybrid topology's
spawned workers are in ``tests/test_torch_hybrid.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import rcca as tr
from repro_torch.data import PlantedCCAData
from repro_torch.exec import (Cluster, Hybrid, Local, PassEngine, Sharded, StackedChunks,
                              as_topology, delta_refit, fit, fit_with_state, n_full_chunks,
                              resolve_slots)
from repro_torch.exec import topology as ttopo
from repro_torch.store import extend_chunks, ingest_chunks, ingest_planted

N, DA, DB, CHUNK = 1536, 28, 20, 128  # 12 chunks
G = 2  # merge group: 6 groups, split over 1-4 slots in batches
CFG = tr.RCCAConfig(k=4, p=8, q=1, nu=0.01, center=True)
SEED = 5


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    data = PlantedCCAData(n=N, da=DA, db=DB, rank=5, noise=0.4, seed=11, chunk=CHUNK)
    return ingest_planted(str(tmp_path_factory.mktemp("ttopo") / "store"), data)


@pytest.fixture(scope="module")
def ragged(tmp_path_factory):
    """12 chunks, the last of 64 rows: a ragged tail group."""
    data = PlantedCCAData(n=1472, da=DA, db=DB, rank=5, noise=0.4, seed=13, chunk=CHUNK)
    return ingest_planted(str(tmp_path_factory.mktemp("tragged") / "store"), data)


@pytest.fixture(scope="module")
def local_fit(store):
    cache = {}

    def get(engine, omega):
        if (engine, omega) not in cache:
            cache[engine, omega] = fit(store, CFG, SEED, engine=engine, omega=omega,
                                       merge_group=G, device="cpu")
        return cache[engine, omega]

    return get


def _same(r1, r2):
    for f in ("Xa", "Xb", "rho", "Qa", "Qb"):
        assert torch.equal(getattr(r1, f), getattr(r2, f)), f"{f} differs"


CASES = [(n, e, o) for n in (1, 2, 3, 4) for e in ("torch", "kernels")
         for o in ("materialized", "seeded")]


@pytest.mark.parametrize("slots,engine,omega", CASES,
                         ids=[f"{n}slots-{e}-{o}" for n, e, o in CASES])
def test_sharded_fit_is_bitwise_the_local_store_fit(store, local_fit, slots, engine, omega):
    res = fit(store, CFG, SEED, topology=Sharded(devices=slots), engine=engine, omega=omega,
              merge_group=G, device="cpu")
    _same(local_fit(engine, omega), res)
    topo = res.diagnostics["topology"]
    assert topo["slots"] == ["cpu"] * slots and topo["n_groups"] == 6
    assert topo["merge_group"] == G and len(topo["passes"]) == CFG.q + 1
    for p in topo["passes"]:
        assert p["slot_device_s"] == [None] * -(-6 // slots)  # one host wait a batch
        assert p["io"]["chunks"] == 12 and p["io"]["rows"] == N
    assert res.diagnostics["schedules"] == local_fit(engine, omega).diagnostics["schedules"]


@pytest.mark.parametrize("slots", [2, 3, 5])
@pytest.mark.parametrize("engine", ["torch", "kernels"])
def test_sharded_ragged_tail_bitwise(ragged, slots, engine):
    """The short last chunk's group is folded on a slot like any other,
    and a short batch runs on fewer slots (5 slots: 6 groups in batches
    of 5 and 1)."""
    assert n_full_chunks(ragged) == ragged.n_chunks - 1
    want = fit(ragged, CFG, SEED, engine=engine, merge_group=G, prefetch=0, device="cpu")
    got = PassEngine(CFG, engine=engine, merge_group=G, device="cpu",
                     topology=Sharded(devices=slots)).run_mesh(ragged, seed=SEED)
    _same(want, got)


def test_run_dispatch_over_stacked_chunks(store):
    """``PassEngine.run`` picks the pass fold by topology; over in-memory
    stacked chunks the Sharded fold is bitwise the Local stream, and the
    multi-process layouts are refused there."""
    A, B = store.materialize()
    chunks = StackedChunks(A.reshape(12, CHUNK, DA), B.reshape(12, CHUNK, DB))
    want = PassEngine(CFG, engine="kernels", merge_group=G, device="cpu").run(chunks, seed=SEED)
    got = PassEngine(CFG, engine="kernels", merge_group=G, device="cpu",
                     topology=Sharded(devices=4)).run(chunks, seed=SEED)
    _same(want, got)
    for topo in (Cluster(2), Hybrid(2, 2)):
        with pytest.raises(ValueError, match="multi-process"):
            PassEngine(CFG, merge_group=G, device="cpu", topology=topo).run(chunks, seed=SEED)


def test_col_axis_is_rejected_for_a_streaming_fit(store):
    with pytest.raises(ValueError, match="col_axis=None"):
        PassEngine(CFG, device="cpu", topology=Sharded(col_axis="model")).run_mesh(
            store, seed=SEED)
    with pytest.raises(ValueError, match="col_axis=None"):
        fit(store, CFG, SEED, topology=Sharded(col_axis="model"), device="cpu")
    with pytest.raises(ValueError, match="cursors"):
        fit(store, CFG, SEED, topology=Sharded(devices=2), ckpt_dir="c", device="cpu")


def test_as_topology_takes_all_four_names():
    assert as_topology("local") == Local()
    assert as_topology("sharded") == Sharded() and Sharded().devices is None
    assert as_topology("sharded", devices=["cuda:0", "cuda:0"]).devices == ("cuda:0", "cuda:0")
    assert as_topology("cluster", n_workers=3) == Cluster(3)
    hyb = as_topology("hybrid", n_workers=3, devices_per_worker=2)
    assert hyb == Hybrid(3, 2) and hyb.name == "hybrid"
    for topo in (Local(), Sharded(devices=2), Cluster(2), Hybrid(2, 2)):
        assert as_topology(topo) is topo
    with pytest.raises(ValueError, match="unknown topology"):
        as_topology("mesh")
    with pytest.raises(ValueError, match="at least one device slot"):
        Sharded(devices=0)


def test_slot_counts_and_lists(monkeypatch):
    """Host slots on the CPU; on a (pretended) one-card host an int above
    the card count raises and names the explicit form, which repeats the
    card; nothing drops to the CPU."""
    assert resolve_slots(None, "cpu") == [torch.device("cpu")]
    assert resolve_slots(3, "cpu") == [torch.device("cpu")] * 3
    assert resolve_slots("cpu,cpu", "cpu") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="not on 'cpu'"):
        resolve_slots(("cuda:0",), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match=r"\('cuda:0', 'cuda:0'\)"):
        resolve_slots(2, "cuda")
    with pytest.raises(ValueError, match="not on 'cuda'"):
        resolve_slots(("cpu", "cuda:0"), "cuda")
    with pytest.raises(ValueError, match="only 1 card"):
        resolve_slots(("cuda:0", "cuda:1"), "cuda")
    assert resolve_slots(None, "cuda") == [torch.device("cuda", 0)]
    assert resolve_slots(("cuda", "cuda:0"), "cuda") == [torch.device("cuda", 0)] * 2
    assert ttopo.worker_slots(2, 2, ("cuda:0",) * 4, "cuda") == [["cuda:0", "cuda:0"]] * 2
    with pytest.raises(ValueError, match="4 device slots asked for"):
        ttopo.worker_slots(2, 2, None, "cuda")
    assert ttopo.worker_slots(3, 2, None, "cpu") == [["cpu", "cpu"]] * 3


def test_traced_sharded_fit_records_mesh_folds(store, local_fit, tmp_path, monkeypatch):
    """Under ``RCCA_TRACE``: one ``mesh_fold`` span a batch (groups, slots,
    the cost model's flops) around ``gather`` and ``chunk`` spans, and
    ``kernel_cost`` calls equal to the traced Local fit's."""
    from repro_torch import obs
    from repro_torch.obs import load_events

    def traced(topology, name):
        monkeypatch.setenv("RCCA_TRACE", str(tmp_path / name))
        try:
            res = fit(store, CFG, SEED, topology=topology, engine="kernels", merge_group=G,
                      device="cpu")
        finally:
            monkeypatch.delenv("RCCA_TRACE")
            obs.close()
        events = load_events(str(tmp_path / name))
        calls = {}
        for e in events:
            if e.get("ev") == "ctr" and e["name"] == "kernel_cost":
                k = e["fields"]["kernel"]
                calls[k] = calls.get(k, 0) + e["fields"]["calls"]
        return res, [e for e in events if e.get("ev") == "span"], calls

    res, spans, calls = traced(Sharded(devices=4), "sharded")
    _, _, local_calls = traced(Local(), "local")
    _same(res, local_fit("kernels", "materialized"))
    folds = [e for e in spans if e["name"] == "mesh_fold"]
    assert [f["attrs"]["groups"] for f in folds] == [4, 2] * (CFG.q + 1)
    assert folds[0]["attrs"]["slots"] == ["cpu"] * 4 and folds[1]["attrs"]["slots"] == ["cpu"] * 2
    assert all(f["attrs"]["flops"] > 0 for f in folds)
    # a gather span a pull: one per chunk, and one a batch for the pull that ends it
    assert sum(e["name"] == "gather" for e in spans) == (12 + 2) * (CFG.q + 1)
    assert sum(e["name"] == "chunk" for e in spans) == 12 * (CFG.q + 1)
    assert calls == local_calls and calls


# -- the Sharded delta refit -----------------------------------------------------


@pytest.fixture(scope="module")
def delta_stores(tmp_path_factory):
    """An 8-chunk store and the same store grown to 11 chunks (a ragged
    merge group at the end), of one planted corpus."""
    root = tmp_path_factory.mktemp("tdelta")
    data = PlantedCCAData(n=1408, da=DA, db=DB, rank=8, noise=0.4, seed=11, chunk=CHUNK)

    def chunks(lo, hi):
        return ((a.astype(np.float32), b.astype(np.float32))
                for a, b in map(data.get_chunk, range(lo, hi)))

    old = ingest_chunks(str(root / "old"), chunks(0, 8), chunk=CHUNK)
    ingest_chunks(str(root / "grown"), chunks(0, 8), chunk=CHUNK)
    return old, extend_chunks(str(root / "grown"), chunks(8, 11))


@pytest.mark.parametrize("omega", ["materialized", "seeded"])
@pytest.mark.parametrize("engine", ["torch", "kernels"])
def test_sharded_fit_with_state_and_delta_refit_are_bitwise(delta_stores, tmp_path, engine,
                                                            omega):
    """Sharded ``fit_with_state`` ≡ the Local one (the result and every
    persisted leaf); the Sharded exact ``delta_refit`` ≡ the Local refit ≡
    the cold fit of the grown store; the frozen refits agree too."""
    old, grown = delta_stores
    kw = dict(merge_group=G, engine=engine, omega=omega, device="cpu")
    r_loc, s_loc = fit_with_state(old, CFG, SEED, **kw)
    r_sh, s_sh = fit_with_state(old, CFG, SEED, topology=Sharded(devices=3), **kw)
    _same(r_loc, r_sh)
    s_loc.save(str(tmp_path / "loc"))
    s_sh.save(str(tmp_path / "sh"))
    for d in ("loc", "sh"):
        with open(os.path.join(tmp_path, d, "manifest.json")) as f:
            man = json.load(f)
        assert man["leaves"], d
    assert json.load(open(tmp_path / "loc" / "manifest.json"))["leaves"] == \
        json.load(open(tmp_path / "sh" / "manifest.json"))["leaves"]
    cold = fit(grown, CFG, SEED, **kw)
    for topo in (Sharded(devices=2), "sharded"):
        res, _ = delta_refit(s_sh, grown, topology=topo, device="cpu")
        _same(res, cold)
        assert res.diagnostics["delta"]["delta_chunks"] == 3
    _same(delta_refit(s_loc, grown, device="cpu")[0], cold)
    _same(delta_refit(s_sh, grown, topology=Sharded(devices=4), mode="frozen", device="cpu")[0],
          delta_refit(s_loc, grown, mode="frozen", device="cpu")[0])


# -- against the reference -------------------------------------------------------


def test_sharded_rho_matches_the_reference_local_store_fit(store):
    """The same store and Ω (the reference's materialized Ω for
    PRNGKey(SEED), fed as numpy) through the reference's Local store fit
    and the port's Sharded fit over three host slots: ρ within 1e-5
    relative."""
    from repro.core.rcca import RCCAConfig as JConfig
    from repro.exec import fit as j_fit

    jcfg = JConfig(k=4, p=8, q=1, nu=0.01, center=True)
    want = j_fit(store.path, jcfg, jax.random.PRNGKey(SEED), engine="jnp", merge_group=G)
    ka, kb = jax.random.split(jax.random.PRNGKey(SEED))
    Qa = np.array(jax.random.normal(ka, (DA, CFG.sketch), jnp.float32))
    Qb = np.array(jax.random.normal(kb, (DB, CFG.sketch), jnp.float32))
    got = fit(store, CFG, Qa=Qa, Qb=Qb, topology=Sharded(devices=3), merge_group=G,
              engine="kernels", device="cpu")
    rho_j = np.asarray(want.rho, np.float64)
    rel = np.max(np.abs(got.rho.numpy().astype(np.float64) - rho_j) / np.abs(rho_j))
    assert rel <= 1e-5, rel
