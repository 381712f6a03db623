"""The Hybrid topology of the port (cluster workers, each folding its
merge groups over its own device slots) and the launcher's
``--topology sharded|hybrid`` and ``--mode dist --data``.

Workers are spawned processes on the CPU (``device="cpu"``: host slots,
the kernels' plain versions); every coordinator call has a time limit on
its workers, and the reference's subprocess its own.  Hybrid fits are
bitwise the port's Local store fit on the same store, Ω, engine and
merge group (``tests/test_exec_topologies.py``'s contract).  The
sharded fit of ``--mode dist --data`` is held to the port's in-memory
dist fit of the same rows and Ω, and to the reference's sharded fit on 4
forced CPU devices fed the same Ω, at ``tests/test_torch_dist.py``'s
tolerances (ρ rtol 1e-4 / atol 1e-5; |Xa|, |Xb| rtol 5e-3 / atol 1e-4).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.cluster import WorkerKilled, run_worker
from repro_torch.cluster import partials as pt
from repro_torch.core import rcca as tr
from repro_torch.data import PlantedCCAData
from repro_torch.exec import Hybrid, fit
from repro_torch.launch import cca_fit
from repro_torch.store import ingest_planted

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DA, DB, CHUNK = 1536, 28, 20, 128  # 12 chunks
G = 2  # merge group: 6 groups
CFG = tr.RCCAConfig(k=4, p=8, q=1, nu=0.01, center=True)
SEED = 5
TIMEOUT = 240.0  # seconds a pass's workers may take before re-dispatch
REF_TIMEOUT = 300.0


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    data = PlantedCCAData(n=N, da=DA, db=DB, rank=5, noise=0.4, seed=11, chunk=CHUNK)
    return ingest_planted(str(tmp_path_factory.mktemp("thybrid") / "store"), data)


def _same(r1, r2):
    for f in ("Xa", "Xb", "rho", "Qa", "Qb"):
        assert torch.equal(getattr(r1, f), getattr(r2, f)), f"{f} differs"


@pytest.mark.parametrize("workers,slots,omega", [(2, 2, "seeded"), (3, 2, "materialized")],
                         ids=["2x2-seeded", "3x2-materialized"])
def test_hybrid_fit_is_bitwise_the_local_store_fit(store, tmp_path, workers, slots, omega):
    want = fit(store, CFG, SEED, merge_group=G, omega=omega, engine="kernels", device="cpu")
    res = fit(store, CFG, SEED, topology=Hybrid(workers, slots), merge_group=G, omega=omega,
              engine="kernels", cluster_dir=str(tmp_path / "cl"), device="cpu",
              worker_timeout=TIMEOUT)
    _same(want, res)
    cl = res.diagnostics["cluster"]
    assert cl["topology"] == "hybrid" and cl["devices_per_worker"] == slots
    assert cl["worker_slots"] == [["cpu"] * slots] * workers
    for p in cl["passes"]:
        assert p["redispatched_groups"] == [] and p["workers_spawned"] == workers
        assert sorted(g for w in p["workers"] for g in w["groups"]) == list(range(6))
        assert all(w["slots"] == ["cpu"] * slots for w in p["workers"])
        assert sum(w["chunks"] for w in p["workers"]) == 12


def _round(store, cluster_dir):
    expect = pt.binding_meta(fit_id="fitH", pass_idx=0, kind="power", engine="kernels",
                             fingerprint=store.fingerprint(), merge_group=G,
                             algo=tr.algo_meta(CFG), omega="materialized")
    Qa, Qb = tr.init_Q(SEED, DA, DB, CFG, device="cpu")
    pt.write_round(cluster_dir, 0, Qa, Qb, {**expect, "n_shards": 2})
    return expect


def test_hybrid_worker_killed_after_a_group_publishes_the_same_partials(store, tmp_path):
    """A Hybrid worker (two host slots) killed after its first group keeps
    that group's partial; run again it folds only the groups still missing,
    and every partial is bitwise a clean Hybrid worker's and a sequential
    worker's."""
    cd_kill, cd_ref, cd_seq = (str(tmp_path / d) for d in ("kill", "ref", "seq"))
    expect = _round(store, cd_kill)
    _round(store, cd_ref)
    _round(store, cd_seq)
    # worker 0 of 2 owns groups 0, 2, 4; on two slots the batches are [0, 2], [4]
    with pytest.raises(WorkerKilled, match="after group 0"):
        run_worker(store.path, cd_kill, 0, 2, 0, prefetch=0, kill_at_chunk=0, device="cpu",
                   devices=2)
    assert set(pt.collect_partials(cd_kill, 0, 6, expect)) == {0}
    report = {}
    assert run_worker(store.path, cd_kill, 0, 2, 0, device="cpu", devices="cpu,cpu",
                      report=report) == 2
    assert report["groups"] == [2, 4] and report["chunks"] == 4
    assert report["slots"] == ["cpu", "cpu"] and len(report["slot_device_s"]) == 1
    assert run_worker(store.path, cd_ref, 0, 2, 0, device="cpu", devices=2) == 3
    assert run_worker(store.path, cd_seq, 0, 2, 0, device="cpu") == 3
    for g in (0, 2, 4):
        s1, _ = pt.read_partial(cd_kill, 0, g)
        for cd in (cd_ref, cd_seq):
            s2, _ = pt.read_partial(cd, 0, g)
            assert all(torch.equal(x, y) for x, y in zip(s1, s2)), (g, cd)


def test_hybrid_fit_with_a_killed_worker_redispatches_its_groups(store, tmp_path):
    from repro_torch.cluster.worker import KILL_ENV

    want = fit(store, CFG, SEED, merge_group=G, engine="torch", device="cpu")
    res = fit(store, CFG, SEED, topology=Hybrid(2, 2), merge_group=G, engine="torch",
              cluster_dir=str(tmp_path / "cl"), device="cpu", worker_timeout=TIMEOUT,
              env_overrides={0: {KILL_ENV: "0:1"}})
    _same(want, res)
    passes = res.diagnostics["cluster"]["passes"]
    assert passes[0]["redispatched_groups"] == [2, 4] and passes[1]["redispatched_groups"] == []


# -- the launcher ----------------------------------------------------------------


def test_cca_fit_sharded_and_hybrid_topologies(tmp_path, capsys):
    """``cca_fit --smoke --data D --topology sharded|hybrid`` on the CPU:
    the Local store fit's ρ and X bit for bit."""
    d = str(tmp_path / "s")
    local = cca_fit.main(["--smoke", "--device", "cpu", "--data", d, "--ingest"])
    sharded = cca_fit.main(["--smoke", "--device", "cpu", "--data", d, "--topology",
                            "sharded", "--devices", "2"])
    hybrid = cca_fit.main(["--smoke", "--device", "cpu", "--data", d, "--topology", "hybrid",
                           "--workers", "2", "--devices-per-worker", "2"])
    out = capsys.readouterr().out
    assert "[cca] sharded topology" in out and "slots ['cpu', 'cpu']" in out
    assert "[cca] hybrid topology" in out and "x 2 slots" in out
    assert "[cca] pass 1 (final)" in out and "[cca] pass 1 cluster:" in out
    for rep in (sharded, hybrid):
        for f in ("rho", "Xa", "Xb"):
            assert torch.equal(getattr(rep.result, f), getattr(local.result, f)), f
    assert hybrid.cluster["topology"] == "hybrid"
    assert sharded.topology["slots"] == ["cpu", "cpu"]


REF_SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core import rcca_dist
from repro.core.rcca import RCCAConfig
from repro.store import ViewStoreReader

store, omega, out = sys.argv[1:4]
q = np.load(omega)
shapes = {q["Qa"].shape: q["Qa"], q["Qb"].shape: q["Qb"]}
rcca_dist.jax.random.normal = lambda key, shape, dtype: jnp.asarray(shapes[tuple(shape)], dtype)
A, B = ViewStoreReader(store).materialize()
mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4, 1), ("pod", "data", "model"))
cfg = RCCAConfig(k=8, p=24, q=1, nu=0.01, center=False)
f = rcca_dist.dist_randomized_cca(jnp.asarray(A), jnp.asarray(B), cfg, jax.random.PRNGKey(0),
                                  mesh, engine="jnp")
np.savez(out, rho=np.asarray(f.rho), Xa=np.asarray(f.Xa), Xb=np.asarray(f.Xb))
"""


def test_cca_fit_dist_from_a_store(tmp_path, capsys):
    """``cca_fit --mode dist --data D``: each rank reads its own rows from
    the store.  Bitwise the in-memory dist fit of the same rows and Ω,
    and within the dist tolerances of the reference's sharded fit on 4
    forced CPU devices (mesh 1 × 4 × 1, the reference's Ω replaced by the
    port's)."""
    d = str(tmp_path / "s")
    argv = ["--smoke", "--device", "cpu", "--mode", "dist", "--ranks", "4", "--mesh", "1,4,1"]
    from_store = cca_fit.main(argv + ["--data", d])  # ingests first
    assert "rows read by each rank from" in capsys.readouterr().out
    in_memory = cca_fit.main(argv)
    for f in ("rho", "Xa", "Xb"):
        assert torch.equal(getattr(from_store.result, f), getattr(in_memory.result, f)), f
    wl = cca_fit.smoke_config()
    Qa, Qb = tr.draw_omega(0, wl.da, wl.db, wl.rcca, device="cpu")
    np.savez(tmp_path / "omega.npz", Qa=Qa.numpy(), Qb=Qb.numpy())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    subprocess.run([sys.executable, "-c", REF_SCRIPT, d, str(tmp_path / "omega.npz"),
                    str(tmp_path / "ref.npz")], env=env, check=True, timeout=REF_TIMEOUT)
    ref = np.load(tmp_path / "ref.npz")
    got = from_store.result
    np.testing.assert_allclose(got.rho.numpy(), ref["rho"], rtol=1e-4, atol=1e-5)
    for f in ("Xa", "Xb"):
        np.testing.assert_allclose(np.abs(getattr(got, f).numpy()), np.abs(ref[f]), rtol=5e-3,
                                   atol=1e-4)
