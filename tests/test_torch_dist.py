"""The resident sharded fit (``repro_torch.core.rcca_dist``), its ops,
mesh and launcher, against the reference's.

- **Ops.** ``project``, ``accumulate_tn``, ``stage_project``,
  ``stage_project_seeded``, ``sweep_accumulate`` and ``gram_accumulate``
  (their plain versions on the CPU) against ``repro.kernels.ops`` in
  interpret mode at ragged shapes, within 4·√K·u of the largest magnitude
  (f32 rounding over a K-term sum taken in two orders).
- **The fit.** The port's ``dist_randomized_cca`` on meshes 1 × 1 × 1,
  1 × 4 × 1, 1 × 2 × 2 and 1 × 1 × 4 (gloo ranks on the CPU), every
  collective, both engines, centering on and off, at the reference's test
  sizes (64 × 32/24, k = 4, p = 4, q = 1, microbatch 16, λ fixed), against
  the reference's ``dist_randomized_cca`` on 4 forced CPU devices (one
  subprocess per module, with ``XLA_FLAGS`` set there only) and against
  the single-device ``repro.core.rcca.randomized_cca``, all on the
  reference's Ω (``jax.random.normal`` of ``split(PRNGKey(0))``, as
  ``rcca_dist.py:389-398`` draws it).  Tolerances are the reference's own
  (``tests/test_collective_fused.py:50-57``): ρ rtol 1e-4 / atol 1e-5;
  |Xa|, |Xb| (columns are sign-ambiguous) rtol 5e-3 / atol 1e-4; with the
  int8 collective rtol 0.05 / atol 0.02, against the reference's own int8
  fit in ρ and X, and against the exact single-device fit in ρ only, as
  the reference holds it (``tests/test_collective_fused.py:60-66``): its
  quantization noise turns the directions of nearly equal ρ (0.956,
  0.946 here) by up to 0.12 in X.
- **The λ fault.** With ν set, the port's λ and ρ do not depend on the
  mesh and equal the single-device reference's; the reference's sharded
  λ is ν·‖A_l‖²/da of one feature shard.
- **Within the port.** unfused ≡ fused bitwise; ρ the same on every
  rank; a size-1 model axis takes the chunk updates; ``dist_orth`` on 2
  and 4 ranks against ``orth`` of the whole Y (projectors within 1e-5,
  ‖QᵀQ − I‖ ≤ 1e-5); the launcher's dist mode against its stream mode;
  a failing or hung rank fails its job instead of hanging the suite.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rcca as jr
from repro.kernels import ops as jops
from repro.launch import mesh as jmesh
from repro_torch.core import rcca as tr
from repro_torch.core import rcca_dist as td
from repro_torch.core.linalg import orth
from repro_torch.data import PlantedCCAData
from repro_torch.exec import Cluster, Local, Sharded, as_topology
from repro_torch.kernels import ops as tops
from repro_torch.kernels import plan, rand
from repro_torch.launch import cca_fit, ranks
from repro_torch.launch.mesh import Mesh, data_axes, host_mesh_shape, make_host_mesh, model_axis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U = 2.0 ** -24
N, DA, DB, K, P, MB = 64, 32, 24, 4, 4, 16
KT = K + P
LAM, NU = 0.1, 0.5
MESHES = [(1, 1, 1), (1, 4, 1), (1, 2, 2), (1, 1, 4)]
ENGINES = ("kernels", "torch")
COLLECTIVES = ("unfused", "fused", "fused-int8ef")
SPAWN_TIMEOUT = 180.0  # seconds; every job is joined with its own limit
REF_TIMEOUT = 600.0

CASES = [(m, e, c, center) for m in MESHES for e in ENGINES for c in COLLECTIVES
         for center in (False, True)]
NU_MESHES = [(1, 2, 2), (1, 1, 4)]  # where the reference's λ shows the fault


def _cid(case):
    m, e, c, center = case
    return f"{'x'.join(map(str, m))}-{e}-{c}-{'center' if center else 'raw'}"


def _ref_key(mesh, engine, collective, center, nu):
    """The reference run a port case is held against: the collective
    matters only to the kernels engine on a real model axis."""
    ref_engine = "jnp" if engine == "torch" else engine
    if ref_engine == "jnp" or mesh[2] == 1:
        collective = "fused"
    return f"{'x'.join(map(str, mesh))}_{ref_engine}_{collective}_{int(center)}_{nu}"


# --------------------------------------------------------------------------
# the reference, on 4 forced CPU devices in its own process
# --------------------------------------------------------------------------

REF_SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core.rcca import RCCAConfig
from repro.core.rcca_dist import dist_randomized_cca

inp, out, runs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
d = np.load(inp)
A, B = jnp.asarray(d["A"]), jnp.asarray(d["B"])
res = {}
for r in runs:
    shape = tuple(r["mesh"])
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                ("pod", "data", "model"))
    cfg = RCCAConfig(k=r["k"], p=r["p"], q=1, lam_a=r["lam"], lam_b=r["lam"], nu=r["nu"],
                     center=r["center"], dtype=jnp.float32)
    f = dist_randomized_cca(A, B, cfg, jax.random.PRNGKey(0), mesh, microbatch=r["mb"],
                            engine=r["engine"], collective=r["collective"])
    for name in ("rho", "Xa", "Xb"):
        res[r["key"] + "/" + name] = np.asarray(getattr(f, name))
    for name in ("lam_a", "lam_b"):
        res[r["key"] + "/" + name] = np.asarray(f.diagnostics[name])
np.savez(out, **res)
"""


def _ref_runs():
    runs = {}
    for m, e, c, center in CASES:
        key = _ref_key(m, e, c, center, None)
        runs[key] = dict(key=key, mesh=m, engine="jnp" if e == "torch" else e,
                         collective=key.split("_")[2], center=center, nu=None)
    for m in NU_MESHES:
        key = _ref_key(m, "torch", "fused", False, NU)
        runs[key] = dict(key=key, mesh=m, engine="jnp", collective="fused", center=False,
                         nu=NU)
    for r in runs.values():
        r.update(k=K, p=P, lam=LAM, mb=MB)
    return list(runs.values())


def _start_reference(tmp, A, B, n_procs=2):
    """The reference's runs, split over ``n_procs`` subprocesses: each run
    compiles its own programs, so they take most of the module's time."""
    np.savez(tmp / "inputs.npz", A=A, B=B)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    runs, jobs = _ref_runs(), []
    for i in range(n_procs):
        out = tmp / f"reference-{i}.npz"
        proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(tmp / "inputs.npz"),
                                 str(out), json.dumps(runs[i::n_procs])], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((proc, out))
    return jobs


# --------------------------------------------------------------------------
# the port, on gloo ranks
# --------------------------------------------------------------------------


def _cfg(center=False, nu=None):
    return tr.RCCAConfig(k=K, p=P, q=1, lam_a=LAM, lam_b=LAM, nu=nu, center=center)


def _block(x, mesh, r, rows_over_data=True):
    """Rank r's block of x under P(("pod", "data"), "model") (Ω:
    P("model", None) with rows_over_data False)."""
    pod, data, model = (int(c) for c in np.unravel_index(r, mesh))
    if not rows_over_data:
        n = x.shape[0] // mesh[2]
        return x[model * n:(model + 1) * n]
    n, d = x.shape[0] // (mesh[0] * mesh[1]), x.shape[1] // mesh[2]
    i = pod * mesh[1] + data
    return x[i * n:(i + 1) * n, model * d:(model + 1) * d]


def _fit_call(mesh, A, B, Qa, Qb, cfg, **kw):
    world = int(np.prod(mesh))
    args = [(_block(A, mesh, r), _block(B, mesh, r), cfg, _block(Qa, mesh, r, False),
             _block(Qb, mesh, r, False), ranks.OnMesh(mesh)) for r in range(world)]
    return ranks.Call(td.dist_randomized_cca, args, dict(microbatch=MB, device="cpu", **kw))


def _assemble(results, mesh):
    """(ρ of every rank, Xa, Xb whole, λa, λb) from the ranks' results:
    X rows from the ranks of row block 0, in model order."""
    rho = [r.rho for r in results]
    Xa = np.concatenate([results[m].Xa for m in range(mesh[2])])
    Xb = np.concatenate([results[m].Xb for m in range(mesh[2])])
    d = results[0].diagnostics
    return rho, Xa, Xb, float(d["lam_a"]), float(d["lam_b"])


def _omega():
    ka, kb = jax.random.split(jax.random.PRNGKey(0))
    return (np.array(jax.random.normal(ka, (DA, KT), jnp.float32)),
            np.array(jax.random.normal(kb, (DB, KT), jnp.float32)))


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Every case of the port (1 × 1 × 1 in this process, the rest in one
    job of 4 ranks), the reference's sharded runs (a subprocess, started
    first so that the two overlap) and its single-device fits."""
    A, B = PlantedCCAData(n=N, da=DA, db=DB, rank=8, seed=3, chunk=N).materialize()
    A, B = A.astype(np.float32), B.astype(np.float32)  # numpy 2 promotes to f64
    Qa, Qb = _omega()
    jobs = _start_reference(tmp_path_factory.mktemp("ref"), A, B)
    try:
        port = {}
        one = Mesh((1, 1, 1))
        for case in CASES:
            m, e, c, center = case
            if m == (1, 1, 1):
                res = td.dist_randomized_cca(A, B, _cfg(center), Qa, Qb, one, microbatch=MB,
                                             engine=e, collective=c, device="cpu")
                port[case] = ranks._to_host([res])
        calls, keys = [], []
        for case in CASES:
            m, e, c, center = case
            if m != (1, 1, 1):
                calls.append(_fit_call(m, A, B, Qa, Qb, _cfg(center), engine=e, collective=c))
                keys.append(case)
        for m in MESHES[1:]:
            calls.append(_fit_call(m, A, B, Qa, Qb, _cfg(nu=NU), engine="kernels"))
            keys.append(("nu", m))
        port[("nu", (1, 1, 1))] = ranks._to_host([td.dist_randomized_cca(
            A, B, _cfg(nu=NU), Qa, Qb, one, microbatch=MB, engine="kernels", device="cpu")])
        Y = np.random.default_rng(11).standard_normal((N, KT)).astype(np.float32)
        calls.append(ranks.Call(td.dist_orth, [(torch.from_numpy(_block(Y, (1, 1, 4), r,
                                                                         False)),
                                                ranks.OnMesh((1, 1, 4)), "model")
                                               for r in range(4)]))
        keys.append(("orth", 4))
        t0 = time.monotonic()
        for key, res in zip(keys, ranks.run(calls, 4, timeout=SPAWN_TIMEOUT)):
            port[key] = res
        port_seconds = time.monotonic() - t0
        deadline = time.monotonic() + REF_TIMEOUT
        logs = [proc.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                for proc, _ in jobs]
    finally:
        for proc, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ref = {}
    for (proc, out), log in zip(jobs, logs):
        assert proc.returncode == 0, log[-4000:]
        ref.update(np.load(out))
    single = {}
    for center, nu in [(False, None), (True, None), (False, NU)]:
        cfg = jr.RCCAConfig(k=K, p=P, q=1, lam_a=LAM, lam_b=LAM, nu=nu, center=center,
                            dtype=jnp.float32)
        single[(center, nu)] = jr.randomized_cca(jnp.asarray(A), jnp.asarray(B), cfg,
                                                 jax.random.PRNGKey(0))
    return dict(A=A, B=B, Y=Y, port=port, ref=ref, single=single, port_seconds=port_seconds)


def _tol(collective):
    return (dict(rtol=0.05, atol=0.02) if collective == "fused-int8ef"
            else dict(rtol=1e-4, atol=1e-5))


def _xtol(collective):
    return (dict(rtol=0.05, atol=0.02) if collective == "fused-int8ef"
            else dict(rtol=5e-3, atol=1e-4))


@pytest.mark.parametrize("case", CASES, ids=[_cid(c) for c in CASES])
def test_fit_matches_reference_sharded_and_single_device(fits, case):
    m, e, c, center = case
    rho, Xa, Xb, lam_a, lam_b = _assemble(fits["port"][case], m)
    for r in rho[1:]:  # finish runs on every rank on the same statistics
        np.testing.assert_array_equal(r, rho[0])
    assert lam_a == pytest.approx(LAM) and lam_b == pytest.approx(LAM)
    key = _ref_key(m, e, c, center, None)
    ref = {name: fits["ref"][f"{key}/{name}"] for name in ("rho", "Xa", "Xb")}
    np.testing.assert_allclose(rho[0], ref["rho"], **_tol(c))
    np.testing.assert_allclose(np.abs(Xa), np.abs(ref["Xa"]), **_xtol(c))
    np.testing.assert_allclose(np.abs(Xb), np.abs(ref["Xb"]), **_xtol(c))
    single = fits["single"][(center, None)]
    np.testing.assert_allclose(rho[0], np.asarray(single.rho), **_tol(c))
    if c == "fused-int8ef" and e == "kernels" and m[2] > 1:
        return  # quantized: held against the exact fit in ρ only (module docstring)
    np.testing.assert_allclose(np.abs(Xa), np.abs(np.asarray(single.Xa)), **_xtol(c))
    np.testing.assert_allclose(np.abs(Xb), np.abs(np.asarray(single.Xb)), **_xtol(c))


@pytest.mark.parametrize("mesh", MESHES, ids=["x".join(map(str, m)) for m in MESHES])
def test_lambda_and_rho_do_not_depend_on_the_mesh(fits, mesh):
    """ν set: the port sums ‖A‖²_F over the feature shards too, so its λ
    and ρ are the single-device reference's at every mesh."""
    rho, _, _, lam_a, lam_b = _assemble(fits["port"][("nu", mesh)], mesh)
    single = fits["single"][(False, NU)]
    A, B = fits["A"], fits["B"]
    np.testing.assert_allclose(lam_a, NU * np.sum(A.astype(np.float64) ** 2) / DA, rtol=1e-5)
    np.testing.assert_allclose(lam_b, NU * np.sum(B.astype(np.float64) ** 2) / DB, rtol=1e-5)
    np.testing.assert_allclose(lam_a, float(single.diagnostics["lam_a"]), rtol=1e-5)
    np.testing.assert_allclose(rho[0], np.asarray(single.rho), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mesh", NU_MESHES, ids=["x".join(map(str, m)) for m in NU_MESHES])
def test_reference_sharded_lambda_is_one_shards(fits, mesh):
    """The fault the port fixes: the reference's sharded λ is ν·‖A_l‖²/da
    of one feature shard (its ‖·‖²_F is summed over the row axes only)."""
    key = _ref_key(mesh, "torch", "fused", False, NU)
    A, B = fits["A"].astype(np.float64), fits["B"].astype(np.float64)
    cols_a, cols_b = DA // mesh[2], DB // mesh[2]
    shard_a = NU * np.sum(A[:, :cols_a] ** 2) / DA
    np.testing.assert_allclose(fits["ref"][f"{key}/lam_a"], shard_a, rtol=1e-5)
    np.testing.assert_allclose(fits["ref"][f"{key}/lam_b"], NU * np.sum(B[:, :cols_b] ** 2) / DB,
                               rtol=1e-5)
    assert abs(shard_a - NU * np.sum(A ** 2) / DA) > 0.1 * shard_a


@pytest.mark.parametrize("mesh", MESHES, ids=["x".join(map(str, m)) for m in MESHES])
@pytest.mark.parametrize("center", [False, True], ids=["raw", "center"])
def test_unfused_is_fused_bitwise(fits, mesh, center):
    """The two collectives run the same products in the same order."""
    u = _assemble(fits["port"][(mesh, "kernels", "unfused", center)], mesh)
    f = _assemble(fits["port"][(mesh, "kernels", "fused", center)], mesh)
    for x, y in zip(u[:3], f[:3]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("world", [2, 4])
def test_dist_orth_against_orth_of_the_whole(fits, world):
    Y = fits["Y"]
    if world == 4:
        parts = fits["port"][("orth", 4)]
    else:
        (parts,) = ranks.run([ranks.Call(td.dist_orth, [
            (torch.from_numpy(_block(Y, (1, 1, 2), r, False)), ranks.OnMesh((1, 1, 2)),
             "model") for r in range(2)])], 2, timeout=SPAWN_TIMEOUT)
    Q = np.concatenate(parts).astype(np.float64)
    Q0 = orth(torch.from_numpy(Y)).double().numpy()
    assert np.abs(Q @ Q.T - Q0 @ Q0.T).max() <= 1e-5
    assert np.abs(Q.T @ Q - np.eye(KT)).max() <= 1e-5


def test_dist_orth_on_one_rank_is_orth_bitwise():
    Y = torch.from_numpy(np.random.default_rng(12).standard_normal((40, 6)).astype(np.float32))
    assert torch.equal(td.dist_orth(Y, Mesh((1, 1, 1)), "model"), orth(Y))


def test_one_rank_mesh_takes_the_chunk_updates(monkeypatch):
    """Without a real model axis the passes call the fused chunk updates,
    never the single products of the sharded collectives."""
    calls = {}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(tops, name, wrapped)

    for name in ("power_pass_chunk", "final_pass_chunk", "project", "accumulate_tn",
                 "stage_project", "sweep_accumulate", "gram_accumulate"):
        count(name, getattr(tops, name))
    rng = np.random.default_rng(1)
    A, B = rng.standard_normal((N, DA)), rng.standard_normal((N, DB))
    Qa, Qb = rng.standard_normal((DA, KT)), rng.standard_normal((DB, KT))
    for collective in COLLECTIVES:
        td.dist_randomized_cca(A, B, _cfg(), Qa, Qb, Mesh((1, 1, 1)), microbatch=MB,
                               engine="kernels", collective=collective, device="cpu")
    assert calls == {"power_pass_chunk": 3 * N // MB, "final_pass_chunk": 3 * N // MB}


def test_topologies():
    assert as_topology("local") == Local()
    sharded = as_topology("sharded", col_axis="model")
    assert isinstance(sharded, Sharded) and sharded.col_axis == "model"
    assert as_topology(sharded) is sharded
    with pytest.raises(ValueError):
        as_topology("mesh")
    assert as_topology("cluster") == Cluster()  # ported: tests/test_torch_cluster.py
    rng = np.random.default_rng(2)
    A, B = rng.standard_normal((N, DA)), rng.standard_normal((N, DB))
    Qa, Qb = rng.standard_normal((DA, KT)), rng.standard_normal((DB, KT))
    one = Mesh((1, 1, 1))
    via_topology = td.dist_randomized_cca(A, B, _cfg(), Qa, Qb, topology=Sharded(one, "model"),
                                          engine="torch", device="cpu")
    direct = td.dist_randomized_cca(A, B, _cfg(), Qa, Qb, one, engine="torch", device="cpu")
    assert torch.equal(via_topology.rho, direct.rho)
    with pytest.raises(ValueError):
        td.dist_randomized_cca(A, B, _cfg(), Qa, Qb, topology=Sharded(), device="cpu")
    with pytest.raises(ValueError):
        td.dist_randomized_cca(A, B, _cfg(), Qa, Qb, device="cpu")


def test_fits_on_one_job_are_the_fits_on_their_own():
    """``fit_dist_runs``: several fits on one job of ranks, the rows and Ω
    made once per mesh, each bitwise the same fit on a job of its own
    (ρ, each rank's Xa/Xb digests and launches), in f32 and bf16 and on a
    second mesh."""
    from repro_torch.configs.europarl_cca import smoke_config

    wl = smoke_config()
    runs = [cca_fit.DistRun((1, 2, 2), collective="unfused"),
            cca_fit.DistRun((1, 2, 2), compute_dtype="bfloat16"),
            cca_fit.DistRun((1, 4, 1))]
    job = cca_fit.fit_dist_runs(wl, runs, n_ranks=4, device="cpu", gather=True)
    for run, rep in zip(runs, job):
        alone = cca_fit.fit_dist(wl, n_ranks=4, mesh_shape=run.mesh_shape,
                                 collective=run.collective, compute_dtype=run.compute_dtype,
                                 device="cpu", gather=True)
        assert rep.mesh == alone.mesh
        np.testing.assert_array_equal(rep.result.rho.numpy(), alone.result.rho.numpy())
        assert [(r["digest"], r["pass_launches"]) for r in rep.ranks] == \
            [(r["digest"], r["pass_launches"]) for r in alone.ranks]
    with pytest.raises(ValueError, match="does not hold"):
        cca_fit.fit_dist_runs(wl, [cca_fit.DistRun((1, 2, 2))], n_ranks=2, device="cpu")


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 16, 32])
def test_host_mesh_shape_is_the_reference_rule(monkeypatch, n):
    monkeypatch.setattr(jmesh.jax, "devices", lambda: list(range(n)))
    monkeypatch.setattr(jmesh.jax, "make_mesh", lambda shape, axes: (tuple(shape), axes))
    want, axes = jmesh.make_host_mesh()
    assert host_mesh_shape(n) == want and axes == ("pod", "data", "model")


def test_make_host_mesh_without_a_process_group():
    mesh = make_host_mesh()
    assert mesh.shape == {"pod": 1, "data": 1, "model": 1}
    assert data_axes(mesh) == ("pod", "data") and model_axis(mesh) == "model"
    short = make_host_mesh((1, 1))  # a shorter shape takes the trailing axis names
    assert short.axis_names == ("data", "model") and data_axes(short) == ("data",)
    assert model_axis(make_host_mesh((1,), ("data",))) is None


def test_mesh_of_one_rank():
    mesh = Mesh((1, 1, 1))
    assert mesh.shape == {"pod": 1, "data": 1, "model": 1}
    assert mesh.coords == {"pod": 0, "data": 0, "model": 0}
    assert mesh.group(("pod", "data")) is None and mesh.group("model") is None
    assert mesh.size(("data", "model")) == 1 and mesh.index("model") == 0
    x = torch.ones(3)
    assert mesh.all_reduce(x, "model") is x
    with pytest.raises(ValueError):
        Mesh((1, 2, 2))  # four ranks, but no process group of four
    with pytest.raises(ValueError):
        mesh.group("expert")


def test_shard_block_copies_what_it_cuts():
    x = torch.arange(24.0).reshape(6, 4)

    class FakeMesh:  # rank (data 1 of 2, model 1 of 2)
        def size(self, axes):
            return 2 if axes else 1

        def index(self, axes):
            return 1 if axes else 0

    block = td.shard_block(x, FakeMesh(), ("data",), "model")
    assert torch.equal(block, x[3:, 2:]) and block.is_contiguous()
    rows = td.shard_block(x, FakeMesh(), ("data",), None)
    assert torch.equal(rows, x[3:]) and rows.untyped_storage().nbytes() == 12 * 4
    assert td.shard_block(x, Mesh((1, 1, 1)), ("data",), "model") is x
    with pytest.raises(ValueError):
        td.shard_block(torch.ones(5, 4), FakeMesh(), ("data",), None)


# --------------------------------------------------------------------------
# the ops the sharded fit calls, against the reference's in interpret mode
# --------------------------------------------------------------------------


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, K):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 4 * np.sqrt(K) * U * scale


OP_SHAPES = [(130, 300, 20), (257, 129, 67), (5, 1000, 3)]


@pytest.mark.parametrize("n,d,kt", OP_SHAPES)
def test_projections_match_reference(n, d, kt):
    x, q = _rand(1, n, d), _rand(2, d, kt)
    want = np.asarray(jops.project(jnp.asarray(x), jnp.asarray(q), interpret=True))
    _close(tops.project(torch.from_numpy(x), torch.from_numpy(q)), want, d)
    want = np.asarray(jops.stage_project(jnp.asarray(x), jnp.asarray(q), interpret=True))
    _close(tops.stage_project(torch.from_numpy(x), torch.from_numpy(q)), want, d)


@pytest.mark.parametrize("n,d,kt", OP_SHAPES)
def test_stage_project_seeded_matches_reference(n, d, kt):
    x = _rand(3, n, d)
    seed = np.asarray(rand.omega_seeds(5)[0], np.uint32)
    want = np.asarray(jops.stage_project_seeded(jnp.asarray(x), jnp.asarray(seed), kt=kt,
                                                q_dtype=jnp.float32, interpret=True))
    _close(tops.stage_project_seeded(torch.from_numpy(x), seed, kt=kt), want, d)


@pytest.mark.parametrize("n,d,kt", OP_SHAPES)
def test_accumulations_match_reference(n, d, kt):
    a, p = _rand(4, n, d), _rand(5, n, kt)
    ja, jp = jnp.asarray(a), jnp.asarray(p)
    ta, tp = torch.from_numpy(a), torch.from_numpy(p)
    _close(tops.accumulate_tn(ta, tp), jops.accumulate_tn(ja, jp, interpret=True), n)
    want = np.asarray(jops.sweep_accumulate(ja, jp, interpret=True))
    _close(tops.sweep_accumulate(ta, tp), want, n)
    acc = torch.from_numpy(_rand(6, d, kt))
    acc0 = acc.clone()
    out = tops.sweep_accumulate(ta, tp, out=acc)
    assert out is acc and torch.equal(out, acc0 + tops.sweep_accumulate(ta, tp))
    _close(tops.gram_accumulate(tp), jops.gram_accumulate(jp, interpret=True), n)


def test_matmul_nn_plan():
    (p,) = plan.plan_matmul_nn(4096, 2 ** 18, 2060)
    # the 128 × 64 tile: 33 column tiles by 32 row tiles, four full waves
    assert p.kernel == "gemm_nn_f32" and p.grid == (33, 32) and p.block == (128,)
    assert p.flops == 2 * 4096 * 2 ** 18 * 2060
    assert p.bytes == 4 * (4096 * 2 ** 18 + 2 ** 18 * 2060 + 4096 * 2060)
    assert plan.plan_matmul_nn(300, 9001, 67) == plan.plan_proj_stage(300, 9001, 67)


# --------------------------------------------------------------------------
# the launcher and the rank harness
# --------------------------------------------------------------------------


def test_launcher_dist_mode_matches_stream_mode(capsys):
    argv = ["--smoke", "--device", "cpu", "--seed", "0"]
    dist_rep = cca_fit.main(argv + ["--mode", "dist", "--ranks", "4"])
    stream_rep = cca_fit.main(argv)
    out = capsys.readouterr().out
    assert "dist mode" in out and "backend=gloo" in out and "mesh={'pod': 1, 'data': 2" in out
    assert dist_rep.mesh == {"pod": 1, "data": 2, "model": 2} and len(dist_rep.ranks) == 4
    assert abs(float(dist_rep.result.rho.sum()) - float(stream_rep.result.rho.sum())) <= 1e-4
    assert dist_rep.result.Xa.shape == (256, 8)  # gathered at --smoke
    for r in dist_rep.ranks:
        assert len(r["pass_seconds"]) == 2 and r["peak_gb"] is None
        assert r["pass_launches"] == [{}, {}]  # plain versions on the CPU


def test_launcher_rejects_a_mesh_that_does_not_hold_the_ranks():
    with pytest.raises(ValueError):
        cca_fit.main(["--smoke", "--device", "cpu", "--mode", "dist", "--ranks", "3",
                      "--mesh", "1,2,2"])


def test_a_failing_rank_fails_the_job():
    rng = np.random.default_rng(4)
    A, B = rng.standard_normal((8, 4)), rng.standard_normal((8, 4))
    Qa, Qb = rng.standard_normal((2, 3)), rng.standard_normal((2, 3))
    bad = rng.standard_normal((3, 3))  # rank 1's Ω block does not match its features
    mesh = ranks.OnMesh((1, 1, 2))
    args = [(A[:, :2], B[:, :2], _cfg(), Qa, Qb, mesh), (A[:, 2:], B[:, 2:], _cfg(), bad, Qb, mesh)]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        ranks.run([ranks.Call(td.dist_randomized_cca, args, dict(device="cpu"))], 2,
                  timeout=SPAWN_TIMEOUT)
    assert time.monotonic() - t0 < SPAWN_TIMEOUT / 2  # rank 0, left waiting, was killed


def test_a_hung_collective_fails_the_job_at_its_time_limit():
    x = torch.ones(3, 2)
    mesh = ranks.OnMesh((1, 1, 2))
    # rank 0 gathers over the model axis; rank 1 skips that collective and
    # then stays alive past the job's limit, so rank 0 waits in it
    calls = [ranks.Call(td.gather_features, [(x, mesh, "model"), (x, mesh, None)]),
             ranks.Call(time.sleep, [(0,), (120,)])]
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        ranks.run(calls, 2, timeout=10.0)
    assert time.monotonic() - t0 < 40.0


def test_rank_results_are_host_values():
    res = ranks._to_host({"a": torch.ones(2), "b": [torch.zeros(1), 3],
                          "c": tr.RCCAResult(torch.ones(1), None, torch.ones(2), None, None, {})})
    assert isinstance(res["a"], np.ndarray) and isinstance(res["b"][0], np.ndarray)
    assert isinstance(res["c"], tr.RCCAResult) and isinstance(res["c"].rho, np.ndarray)
    assert dataclasses.is_dataclass(ranks.OnMesh((1, 1, 1)))
