"""Fault tolerance of the port's cluster barrier: killed and hung workers,
stale partials and beacons of earlier fits, duplicate publications and
unrecoverable shards (the counterparts of ``tests/test_cluster_failures.py``).
Under every recoverable failure the coordinator's result stays bitwise
the port's Local store fit on the same store.  Workers run on the CPU;
every pass's workers have a time limit, after which the coordinator
re-dispatches or raises.
"""

import os
import time

import pytest
import torch

from repro_torch.cluster import ClusterCoordinator, run_worker
from repro_torch.cluster import partials as pt
from repro_torch.cluster.worker import HANG_ENV, KILL_ENV
from repro_torch.core import rcca as tr
from repro_torch.data import PlantedCCAData
from repro_torch.exec import fit
from repro_torch.store import ingest_planted

N, DA, DB, CHUNK = 1536, 28, 20, 128  # 12 chunks, 6 merge groups
G = 2
CFG = tr.RCCAConfig(k=4, p=8, q=1, nu=0.01, center=True)
SEED = 5
TIMEOUT = 240.0


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    data = PlantedCCAData(n=N, da=DA, db=DB, rank=5, noise=0.4, seed=11, chunk=CHUNK)
    return ingest_planted(str(tmp_path_factory.mktemp("tclfail") / "store"), data)


@pytest.fixture(scope="module")
def ref(store):
    return fit(store, CFG, SEED, engine="torch", merge_group=G, device="cpu")


def _coord(store, cluster_dir, **kw):
    kw.setdefault("worker_timeout", TIMEOUT)
    return ClusterCoordinator(store, CFG, str(cluster_dir), engine="torch", merge_group=G,
                              device="cpu", **kw)


def _same(r1, r2):
    for f in ("Xa", "Xb", "rho", "Qa", "Qb"):
        assert torch.equal(getattr(r1, f), getattr(r2, f)), f"{f} differs"


@pytest.mark.parametrize("kill", ["0:2", "1:2"], ids=["mid-power-pass", "mid-final-pass"])
def test_killed_worker_redispatches_bitwise(store, ref, tmp_path, kill):
    """Worker 0 dies hard (``os._exit``, no clean-up) mid-pass; the barrier
    re-dispatches its unfinished groups to a repair worker and the merged
    result is still the Local fit's bits."""
    res = _coord(store, tmp_path / "cl", n_workers=2,
                 env_overrides={0: {KILL_ENV: kill}}).fit(SEED)
    _same(ref, res)
    killed = int(kill.split(":")[0])
    passes = res.diagnostics["cluster"]["passes"]
    # worker 0 owns groups 0, 2, 4: chunk 2 is group 1's, so it dies after
    # chunk 4, with group 0 published and groups 2 and 4 not
    assert passes[killed]["redispatched_groups"] == [2, 4]
    assert passes[killed]["workers_spawned"] == 3
    assert passes[1 - killed]["redispatched_groups"] == []
    # the killed worker printed no report; the survivor and the repair did
    assert sorted(w["shard"] for w in passes[killed]["workers"]) == [1, 2]


def test_stale_partials_of_an_earlier_fit_are_replaced(store, ref, tmp_path):
    """A reused cluster directory: the first fit's partials carry another
    fit id, so the second fit must not merge them."""
    co = _coord(store, tmp_path / "cl", n_workers=2)
    first = co.fit(123)  # another seed: other partials
    assert not torch.equal(first.rho, ref.rho)
    _same(ref, co.fit(SEED))


def test_a_duplicate_publication_merges_once(store, ref, tmp_path):
    """A zombie owner re-running its shard after the fit finds every group
    published under the fit's binding and publishes nothing."""
    cd = tmp_path / "cl"
    res = _coord(store, cd, n_workers=2).fit(SEED)
    _same(ref, res)
    assert run_worker(store.path, str(cd), 0, 2, 0, prefetch=0, device="cpu") == 0
    assert run_worker(store.path, str(cd), 1, 2, 1, prefetch=0, device="cpu") == 0
    plan, missing = pt.collect_coverage(str(cd), 0, 6, pt.partial_meta(str(cd), 0, 0))
    assert sorted(plan) == list(range(6)) and missing == []


def test_a_hung_worker_is_redispatched_by_its_heartbeat(store, ref, tmp_path):
    """A worker that wedges (alive, no progress) stops beating; the
    coordinator kills it and re-dispatches its groups long before the
    pass's time limit, and the result keeps the Local fit's bits."""
    res = _coord(store, tmp_path / "cl", n_workers=2, worker_timeout=600,
                 heartbeat_timeout=20, env_overrides={0: {HANG_ENV: "0:2"}}).fit(SEED)
    _same(ref, res)
    passes = res.diagnostics["cluster"]["passes"]
    assert passes[0]["stale_heartbeat_shards"] == [0]
    assert passes[0]["redispatched_groups"] == [2, 4]
    assert passes[1]["stale_heartbeat_shards"] == [] and passes[1]["redispatched_groups"] == []
    assert passes[0]["wall_s"] < 300  # not the 600 s pass limit


def test_a_stale_beacon_of_an_earlier_fit_is_ignored(store, ref, tmp_path):
    """An hour-old beacon under the same shard and pass must not condemn
    a worker that has not had time to beat yet: an age is bounded by the
    time since the spawn."""
    cd = str(tmp_path / "cl")
    pt.touch_heartbeat(cd, 0, 0)
    ancient = time.time() - 3600
    os.utime(pt.heartbeat_path(cd, 0, 0), (ancient, ancient))
    res = _coord(store, cd, n_workers=2, heartbeat_timeout=30).fit(SEED)
    _same(ref, res)
    passes = res.diagnostics["cluster"]["passes"]
    assert all(p["stale_heartbeat_shards"] == [] and p["redispatched_groups"] == []
               for p in passes)


def test_an_unrecoverable_shard_raises_and_names_its_groups(store, tmp_path):
    """Every dispatch of the shard dies: after ``max_redispatch`` rounds the
    pass raises, naming the missing groups, and leaves no worker running."""
    co = _coord(store, tmp_path / "cl", n_workers=1, max_redispatch=1)
    spawned = []
    orig = co._spawn

    def spawn_killed(shard, pass_idx, **kw):
        kw["extra_env"] = {KILL_ENV: "0:0"}
        spawned.append(orig(shard, pass_idx, **kw))
        return spawned[-1]

    co._spawn = spawn_killed
    with pytest.raises(RuntimeError, match=r"merge groups \[0, 1, 2, 3, 4, 5\] still missing"):
        co.fit(SEED)
    assert len(spawned) == 2 and all(p.poll() is not None for p in spawned)
