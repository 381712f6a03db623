"""The Cluster topology of the port: group-level merge entry points,
rounds and partials on disk, workers and the coordinator.

The contract is the reference's: for any worker count and combine span,
the coordinator's result is bitwise the port's Local store fit on the
same store, Ω, engine and merge group (partials are group sums folded
with the Local fit's updates, merged through the same pairwise tree).
Against the reference's Local store fit (``repro.exec.fit``, jnp engine,
the same Ω fed as numpy) ρ agrees within 1e-5 relative.  Workers run
on the CPU here (``device="cpu"``: the plain versions of the kernels);
every coordinator call has a time limit on its workers.
"""

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import load_flat as j_load_flat
from repro.exec import accumulate as jacc
from repro_torch.cluster import ClusterCoordinator, WorkerKilled, run_worker
from repro_torch.cluster import partials as pt
from repro_torch.core import rcca as tr
from repro_torch.data import PlantedCCAData
from repro_torch.exec import (Cluster, Hybrid, PairwiseStack, SegmentedAccumulator,
                              SpanCombiner, as_topology, fit, reduce_group_partials)
from repro_torch.store import ingest_planted

N, DA, DB, CHUNK = 1536, 28, 20, 128  # 12 chunks
G = 2  # merge group: 6 groups, split unevenly over 4 workers
CFG = tr.RCCAConfig(k=4, p=8, q=1, nu=0.01, center=True)
SEED = 5
TIMEOUT = 240.0  # seconds a pass's workers may take before re-dispatch


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    data = PlantedCCAData(n=N, da=DA, db=DB, rank=5, noise=0.4, seed=11, chunk=CHUNK)
    return ingest_planted(str(tmp_path_factory.mktemp("tcluster") / "store"), data)


@pytest.fixture(scope="module")
def local_fit(store):
    """The port's Local store fit per (engine, omega)."""
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


# -- the group-level entry points of the canonical tree -----------------------


class Two(NamedTuple):
    y: torch.Tensor
    n: torch.Tensor


def _groups(n_groups, seed):
    """Group sums whose magnitudes spread over 12 decades: f32 sums are
    then order-sensitive, and equal bits mean equal reduction trees."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n_groups, 5, 3)) * 10.0 ** rng.integers(-6, 6, (n_groups, 5, 3))
    n = rng.standard_normal(n_groups) * 10.0 ** rng.integers(-6, 6, n_groups)
    return [Two(torch.from_numpy(y[g].astype(np.float32)),
                torch.from_numpy(np.asarray(n[g], np.float32))) for g in range(n_groups)]


def _singles(groups):
    st = PairwiseStack()
    for i, s in enumerate(groups):
        st.push(s, more=i + 1 < len(groups))
    return st.result()


def _bits(x, y):
    return all(np.array_equal(np.array(a), np.array(b)) for a, b in zip(x, y))


# aligned dyadic span sequences: each span starts at a multiple of its weight
SPANS = {"4+2+1": [4, 2, 1], "1+1+2+4": [1, 1, 2, 4], "2+2+4+1+1+2": [2, 2, 4, 1, 1, 2],
         "8+4+1": [8, 4, 1], "4+4+4+4": [4, 4, 4, 4], "1x5": [1] * 5}


@pytest.mark.parametrize("spans", list(SPANS.values()), ids=list(SPANS))
def test_push_span_is_bitwise_the_single_pushes(spans):
    """A span pushed as one entry of its weight merges as its groups
    pushed one by one: PairwiseStack.push_span and
    SegmentedAccumulator.push_group_span both, against the reference's
    accumulator fed the same groups."""
    n_groups = sum(spans)
    groups = _groups(n_groups, n_groups)
    want = _singles(groups)
    st = PairwiseStack()
    acc = SegmentedAccumulator(lambda: None, n_groups * G, G)
    g = 0
    for i, span in enumerate(spans):
        part = _singles(groups[g:g + span])
        st.push_span(part, span, more=i + 1 < len(spans))
        acc.push_group_span(g, part, span)
        g += span
    assert st.counts == PairwiseStack.counts_after(n_groups)
    assert _bits(st.result(), want) and _bits(acc.result(), want)
    jgroups = [type(s)(*(jnp.asarray(t.numpy()) for t in s)) for s in groups]
    jref = jacc.reduce_group_partials(dict(enumerate(jgroups)), lambda: None, n_groups * G, G)
    assert _bits(want, jref)
    acc.close()
    st.close()


def test_push_group_span_rejects_what_is_not_a_subtree():
    """After 3 groups the stack holds weights [2, 1]: a span of 4 from
    group 3 is unaligned (4 single pushes there would merge into [4, 2,
    1], not [2, 1, 4]) and raises, as do gaps, overruns and weights that
    are not powers of two."""
    groups = _groups(6, 1)
    acc = SegmentedAccumulator(lambda: None, 6 * G, G)
    for g in range(3):
        acc.push_group(g, groups[g])
    assert acc._tree.counts == [2, 1]
    with pytest.raises(ValueError, match="unaligned"):
        acc.push_group_span(3, groups[3], 4)
    with pytest.raises(ValueError, match="in order"):
        acc.push_group(4, groups[4])
    with pytest.raises(ValueError, match="power of two"):
        acc.push_group_span(3, groups[3], 3)
    acc.push_group(3, groups[3])
    with pytest.raises(ValueError, match="overruns"):
        acc.push_group_span(4, groups[4], 4)
    with pytest.raises(ValueError, match="power of two"):
        PairwiseStack().push_span(groups[0], 0)
    acc.close()


# (combine span, the worker's groups): a run from 0, a repair worker's
# unaligned start, a run that breaks, a trailing short run
COMBINER = {"span 1": (1, [0, 1, 2, 3, 4]), "span 2": (2, [0, 1, 4, 5, 6]),
            "span 4": (4, [0, 1, 2, 3, 4, 5]), "span 4 unaligned start": (4, [3, 4, 5, 6, 7, 9]),
            "span 2 broken runs": (2, [1, 2, 3, 6, 8, 9])}


@pytest.mark.parametrize("case", list(COMBINER.values()), ids=list(COMBINER))
def test_span_combiner_is_bitwise_per_group_pushes(case):
    """What a worker's combiner publishes, merged downstream, is bitwise
    its groups merged one by one: every emitted span is aligned, lies in
    the worker's groups and covers each of them once."""
    span, owned = case
    groups = _groups(10, span)
    out = []
    comb = SpanCombiner(span, lambda g, w, s: out.append((g, w, Two(*(t.clone() for t in s)))))
    for g in owned:
        comb.emit(g, groups[g])
    comb.flush()
    covered = [g for g0, w, _ in out for g in range(g0, g0 + w)]
    assert covered == owned
    assert all(w & (w - 1) == 0 and g0 % w == 0 and w <= span for g0, w, _ in out)
    for g0, w, s in out:
        assert _bits(s, _singles(groups[g0:g0 + w]))


def test_reduce_group_partials_is_the_accumulator_and_needs_every_group():
    groups = _groups(6, 3)
    acc = SegmentedAccumulator(lambda: None, 6 * G, G)
    for g, s in enumerate(groups):
        acc.push_group(g, s)
    want = acc.result()
    for order in (range(6), reversed(range(6)), [3, 0, 5, 1, 4, 2]):
        got = reduce_group_partials({g: groups[g] for g in order}, lambda: None, 6 * G, G)
        assert _bits(got, want)
    with pytest.raises(ValueError, match="missing"):
        reduce_group_partials({0: groups[0]}, lambda: None, 6 * G, G)


def test_stack_close_stops_the_worker_and_is_idempotent():
    st = PairwiseStack()
    groups = _groups(3, 4)
    for s in groups:
        st.push(s)
    st.close()
    st.close()
    assert st._worker._shutdown and st._pending is None
    assert _bits(st.result(), _singles(groups))


def test_as_topology_cluster_and_unported_layouts():
    """Every layout is ported now: ``"hybrid"`` is the reference's
    ``Hybrid`` (2 workers × 4 slots by default) and checks its own."""
    assert as_topology("cluster") == Cluster() and Cluster(3).devices_per_worker == 1
    with pytest.raises(ValueError, match="at least one worker"):
        Cluster(0)
    assert as_topology("hybrid") == Hybrid() and Hybrid().devices_per_worker == 4
    with pytest.raises(ValueError, match="at least one device per worker"):
        Hybrid(2, 0)
    with pytest.raises(ValueError, match="2 × 2 devices"):
        Hybrid(2, 2, devices=("cpu",) * 3)


# -- rounds and partials on disk -------------------------------------------------


def _expect(store, pass_idx=0, kind="power", engine="torch", fit_id="fitX",
            omega="materialized"):
    return pt.binding_meta(fit_id=fit_id, pass_idx=pass_idx, kind=kind, engine=engine,
                           fingerprint=store.fingerprint(), merge_group=G,
                           algo=tr.algo_meta(CFG), omega=omega)


def _publish_round(store, cluster_dir, **kw):
    expect = _expect(store, **kw)
    Qa, Qb = tr.init_Q(SEED, DA, DB, CFG, device="cpu")
    pt.write_round(cluster_dir, 0, Qa, Qb, {**expect, "n_shards": 2})
    return expect, Qa, Qb


def test_round_and_partial_round_trip(store, tmp_path):
    cd = str(tmp_path / "cl")
    expect, Qa, Qb = _publish_round(store, cd)
    Qa2, Qb2, meta = pt.read_round(cd, 0)
    assert torch.equal(Qa, Qa2) and torch.equal(Qb, Qb2) and pt.binding_matches(meta, expect)
    # a seeded pass 0 ships the two seed words per view, not Ω
    seeds = tr.omega_seeds(SEED)
    sexp = _expect(store, omega="seeded", fit_id="fitS")
    assert pt.write_round(str(tmp_path / "s"), 0, *seeds, sexp) == 32
    sa, sb, _ = pt.read_round(str(tmp_path / "s"), 0)
    assert (sa, sb) == seeds
    stats = tr.stats_init_fn("power", DA, DB, CFG.sketch, "cpu")()
    stats = stats._replace(Ya=torch.randn(DA, CFG.sketch), n=torch.tensor(7.0))
    nbytes = pt.write_partial(cd, 0, 3, stats, expect, shard=1, n_shards=2, span=1)
    assert nbytes == sum(t.numel() * 4 for t in stats)
    got, meta = pt.read_partial(cd, 0, 3)
    assert type(got) is tr.PowerStats and all(torch.equal(x, y) for x, y in zip(got, stats))
    assert meta["group"] == 3 and meta["shard"] == 1 and pt.binding_matches(meta, expect)
    # the reference's checkpoint reader takes the port's partial
    flat, jmeta = j_load_flat(pt.partial_path(cd, 0, 3))
    assert np.array_equal(np.asarray(flat["Ya"]), stats.Ya.numpy()) and jmeta["span"] == 1
    # a duplicate publication keeps one valid partial; a stale one is replaced
    pt.write_partial(cd, 0, 3, stats, expect, shard=0, n_shards=2)
    assert pt.collect_partials(cd, 0, 6, expect) == {3: pt.partial_meta(cd, 0, 3)}
    other = {**expect, "fit_id": "older"}
    assert not pt.binding_matches(pt.partial_meta(cd, 0, 3), other)
    assert pt.sweep_stale_partials(cd, 0, 6, other) == {}
    assert pt.scan_partials(cd, 0) == []


def test_coverage_prefers_the_widest_aligned_span(store, tmp_path):
    cd = str(tmp_path / "cl")
    expect = _expect(store)
    s = tr.stats_init_fn("power", DA, DB, CFG.sketch, "cpu")()
    for g, span in [(0, 2), (0, 1), (2, 1), (4, 2), (3, 2)]:  # (3, 2) is unaligned
        pt.write_partial(cd, 0, g, s, expect, shard=0, n_shards=1, span=span)
    pt.write_partial(cd, 0, 5, s, {**expect, "engine": "kernels"}, shard=0, n_shards=1)
    plan, missing = pt.collect_coverage(cd, 0, 6, expect)
    assert {g: span for g, (span, _) in plan.items()} == {0: 2, 2: 1, 4: 2} and missing == [3]


@pytest.mark.parametrize("key", ["fit_id", "pass_idx", "kind", "engine", "fingerprint",
                                 "merge_group", "algo", "omega", "version"])
def test_binding_mismatch_on_every_key(store, key):
    expect = _expect(store)
    assert pt.binding_matches(dict(expect), expect)
    assert not pt.binding_matches({**expect, key: "other"}, expect)
    assert not pt.binding_matches(None, expect)


# -- the coordinator, bitwise the Local store fit -----------------------------

# (workers, combine, omega, engine): every worker count, combine span, Ω
# mode and engine, in six fits
CASES = [(1, 1, "materialized", "torch"), (2, 1, "seeded", "kernels"),
         (4, 2, "materialized", "kernels"), (2, 2, "seeded", "torch"),
         (4, 1, "seeded", "kernels"), (1, 2, "materialized", "kernels")]


@pytest.mark.parametrize("workers,combine,omega,engine", CASES,
                         ids=[f"w{w}-c{c}-{o}-{e}" for w, c, o, e in CASES])
def test_cluster_fit_is_bitwise_the_local_store_fit(store, local_fit, tmp_path, workers,
                                                    combine, omega, engine):
    res = fit(store, CFG, SEED, topology=Cluster(workers), cluster_dir=str(tmp_path / "cl"),
              merge_group=G, omega=omega, engine=engine, combine_groups=combine,
              device="cpu", worker_timeout=TIMEOUT)
    _same(local_fit(engine, omega), res)
    cl = res.diagnostics["cluster"]
    assert cl["n_workers"] == workers and cl["n_groups"] == 6 and cl["combine_groups"] == combine
    for p in cl["passes"]:
        assert p["redispatched_groups"] == [] and p["merge_fan_in"] == -(-6 // combine)
        assert p["workers_spawned"] == min(workers, -(-6 // combine))
        assert sorted(g for w in p["workers"] for g in w["groups"]) == list(range(6))
        assert all(w["device"] == "cpu" and w["launches"] == {} for w in p["workers"])
        assert p["partial_bytes"] > 0 and p["round_bytes"] > 0
    # the seeded pass 0 broadcast the seeds, two int64 words a view
    assert (cl["passes"][0]["round_bytes"] == 32) == (omega == "seeded")


def test_cluster_rho_matches_the_reference_local_store_fit(store, tmp_path):
    """The same store and Ω (the reference's materialized Ω for
    PRNGKey(SEED), fed as numpy) through the reference's Local store fit
    and the port's cluster: ρ within 1e-5 relative."""
    from repro.core.rcca import RCCAConfig as JConfig
    from repro.exec import fit as j_fit

    jcfg = JConfig(k=4, p=8, q=1, nu=0.01, center=True)
    want = j_fit(store.path, jcfg, jax.random.PRNGKey(SEED), engine="jnp", merge_group=G)
    ka, kb = jax.random.split(jax.random.PRNGKey(SEED))
    Qa = np.array(jax.random.normal(ka, (DA, CFG.sketch), jnp.float32))
    Qb = np.array(jax.random.normal(kb, (DB, CFG.sketch), jnp.float32))
    got = fit(store, CFG, Qa=Qa, Qb=Qb, topology="cluster", cluster_dir=str(tmp_path / "cl"),
              merge_group=G, engine="torch", device="cpu", worker_timeout=TIMEOUT)
    rho_j = np.asarray(want.rho, np.float64)
    rel = np.max(np.abs(got.rho.numpy().astype(np.float64) - rho_j) / np.abs(rho_j))
    assert rel <= 1e-5, rel


def test_fit_needs_a_cluster_dir_and_refuses_the_local_cursors(store, tmp_path):
    with pytest.raises(ValueError, match="cluster_dir"):
        fit(store, CFG, SEED, topology="cluster", device="cpu")
    with pytest.raises(ValueError, match="ckpt_dir"):
        fit(store, CFG, SEED, topology=Cluster(2), cluster_dir=str(tmp_path / "cl"),
            ckpt_dir=str(tmp_path / "ck"), device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        ClusterCoordinator(store, CFG, str(tmp_path / "cl"), combine_groups=3, device="cpu")


# -- worker behaviour -----------------------------------------------------------


def test_worker_killed_mid_shard_resumes_from_cursor(store, tmp_path):
    """A killed worker re-run with the same shard id continues mid-shard:
    published groups are skipped, the open group resumes from its cursor
    (the store is not read again for its folded chunk), and the partials
    are bitwise those of a worker that was never killed."""
    cd_kill, cd_ref = str(tmp_path / "kill"), str(tmp_path / "ref")
    expect, _, _ = _publish_round(store, cd_kill)
    _publish_round(store, cd_ref)
    # worker 0 of 2 owns groups 0, 2, 4 = chunks 0, 1, 4, 5, 8, 9; a cursor
    # after every chunk, the kill after chunk 8 (mid-way through group 4)
    with pytest.raises(WorkerKilled):
        run_worker(store.path, cd_kill, 0, 2, 0, ckpt_every=1, prefetch=0, kill_at_chunk=8,
                   device="cpu")
    assert set(pt.collect_partials(cd_kill, 0, 6, expect)) == {0, 2}
    report = {}
    assert run_worker(store.path, cd_kill, 0, 2, 0, prefetch=0, device="cpu",
                      report=report) == 1
    assert report["resumed_at"] == 9 and report["chunks"] == 1 and report["groups"] == [4]
    assert report["io"]["rows"] == CHUNK
    assert run_worker(store.path, cd_ref, 0, 2, 0, prefetch=2, device="cpu") == 3
    for g in (0, 2, 4):
        s1, _ = pt.read_partial(cd_kill, 0, g)
        s2, _ = pt.read_partial(cd_ref, 0, g)
        assert all(torch.equal(x, y) for x, y in zip(s1, s2)), g


def test_worker_is_idempotent_after_completion(store, tmp_path):
    cd = str(tmp_path / "idem")
    _publish_round(store, cd)
    assert run_worker(store.path, cd, 1, 2, 0, prefetch=0, device="cpu") == 3
    assert run_worker(store.path, cd, 1, 2, 0, prefetch=0, device="cpu") == 0


def test_worker_rejects_a_foreign_store(store, tmp_path):
    cd = str(tmp_path / "foreign")
    other = ingest_planted(str(tmp_path / "other"),
                           PlantedCCAData(n=N, da=DA, db=DB, rank=5, seed=99, chunk=CHUNK))
    _publish_round(other, cd)
    with pytest.raises(ValueError, match="different store"):
        run_worker(store.path, cd, 0, 2, 0, prefetch=0, device="cpu")


def test_worker_refuses_the_card_without_cuda(store, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    cd = str(tmp_path / "nocuda")
    _publish_round(store, cd)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_worker(store.path, cd, 0, 2, 0)
    assert pt.scan_partials(cd, 0) == []


def test_worker_cli_refuses_device_meshes():
    """``--devices`` makes a Hybrid worker now; the worker refuses the
    slot lists it cannot place (slots of another kind than ``--device``,
    no slot at all) before it reads anything."""
    from repro_torch.cluster import worker

    argv = ["--store", "s", "--cluster-dir", "c", "--shard", "0", "--n-shards", "1",
            "--pass-idx", "0", "--device", "cpu"]
    with pytest.raises(ValueError, match="not on 'cpu'"):
        worker.main(argv + ["--devices", "cuda:0,cuda:0"])
    with pytest.raises(ValueError, match="at least one device slot"):
        worker.main(argv + ["--devices", "0"])



# -- the launcher -------------------------------------------------------------------


def test_cca_fit_topology_cluster(tmp_path, capsys):
    """``cca_fit --data D --ingest --topology cluster --workers 2`` prints each
    pass's cluster line and worker lines and gives the local store fit's ρ."""
    from repro_torch.launch import cca_fit

    d = str(tmp_path / "s")
    rep = cca_fit.main(["--smoke", "--device", "cpu", "--data", d, "--ingest", "--topology",
                        "cluster", "--workers", "2"])
    out = capsys.readouterr().out
    assert "[cca] cluster topology" in out and "[cca] pass 1 cluster:" in out
    assert "[cca] pass 0 worker 0 on cpu" in out and "exact-oracle objective gap" in out
    assert rep.cluster["n_workers"] == 2 and os.path.isdir(d + ".cluster")
    local = cca_fit.main(["--smoke", "--device", "cpu", "--data", d])
    assert torch.equal(rep.result.rho, local.result.rho)


@pytest.mark.parametrize("argv,match", [
    (["--topology", "cluster"], "needs an on-disk store"),
    (["--workers", "2"], "needs an on-disk store"),
    (["--data", "D", "--topology", "cluster", "--mode", "dist"], "stream mode only"),
    (["--data", "D", "--workers", "2", "--ckpt-dir", "C"], "cluster-dir"),
])
def test_cca_fit_cluster_flags_are_checked(argv, match):
    from repro_torch.launch import cca_fit

    with pytest.raises(SystemExit, match=match):
        cca_fit.main(["--smoke", "--device", "cpu"] + argv)
