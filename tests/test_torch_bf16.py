"""The bf16-operand forms of the port's kernels, and the sharded fit at
``compute_dtype=torch.bfloat16``, against the reference's.

- **Ops.** Every ``ops`` wrapper the bf16 sharded fit calls (their plain
  versions on the CPU) against ``repro.kernels.ops`` in interpret mode on
  the same bf16 operands: ``project``, ``accumulate_tn``,
  ``stage_project``, ``sweep_accumulate`` with a bf16 P and with an f32 P
  (the reference promotes the mixed product), ``gram_accumulate`` with a
  bf16 P, and the chunk updates ``power_pass_chunk`` / ``final_pass_chunk``
  at a shape the rule recomputes and one it stages.  Inputs are made with
  numpy from a seed and rounded to bf16 by each package (the same bits,
  checked).  Tolerance 4·√K·u of the largest magnitude: the products of
  bf16 values are exact in f32 on both sides, so what differs is the f32
  summation order over a K-term sum.
- **The fit.** The port's bf16 ``dist_randomized_cca`` on meshes 1 × 1 × 1,
  1 × 4 × 1 and 1 × 2 × 2 (gloo ranks on the CPU), every collective on the
  kernels engine and the torch engine, against the reference's bf16
  ``dist_randomized_cca`` on 4 forced CPU devices (its own subprocess) on
  the same Ω: ρ within 1e-4 (int8ef: rtol 0.05 / atol 0.02, the
  reference's own tolerance); unfused ≡ fused bitwise.  The reference
  runs with ``--xla_allow_excess_precision=false``: by default XLA drops
  the bf16 round trip of its jnp engine's P = X·Q (a bf16 product that the
  next product widens again) and keeps P in f32, which is not what the
  reference's code says; the port's torch engine rounds P to bf16 as
  written (with the flag the two give the same Y bitwise), and at
  1 × 1 × 1 their ρ differ by 2e-4 without it.
- **Dispatch.** Every (entry point, operand dtypes) pair the bf16 fit
  calls maps to a C function that ``build.SIGNATURES`` declares; every
  other pair raises ``TypeError`` on the card.
- **Plans and the rule.** bf16 byte counts; the rule's bf16 decisions at
  the Europarl and smoke shapes are the reference's.
- **Launcher.** ``cca_fit --mode dist --compute-dtype bfloat16`` against
  the API call; stream mode runs bf16 (``tests/test_torch_seeded_bf16.py``
  holds its fits); float16 is refused.
- **On the card** (skips without CUDA): each bf16 form against its plain
  version and the bitwise contracts, at ragged shapes.
"""

import itertools
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.powerpass import choose_powerpass_schedule as j_choose_power
from repro.kernels.projgram import choose_projgram_schedule as j_choose_gram
from repro_torch import kernels as tk
from repro_torch.configs.europarl_cca import smoke_config
from repro_torch.core import rcca as tr
from repro_torch.core import rcca_dist as td
from repro_torch.data import PlantedCCAData
from repro_torch.kernels import build, matmul, plan, ref
from repro_torch.kernels import ops as tops
from repro_torch.launch import cca_fit, ranks
from repro_torch.launch.mesh import Mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U = 2.0 ** -24
BF16, F32 = torch.bfloat16, torch.float32
N, DA, DB, K, P, MB = 64, 32, 24, 4, 4, 16
KT = K + P
LAM = 0.1
MESHES = [(1, 1, 1), (1, 4, 1), (1, 2, 2)]
COLLECTIVES = ("unfused", "fused", "fused-int8ef")
CASES = [(m, "kernels", c) for m in MESHES for c in COLLECTIVES] + [
    (m, "torch", "fused") for m in MESHES]
SPAWN_TIMEOUT = 180.0
REF_TIMEOUT = 600.0


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(x, dtype=BF16):
    """The same numpy values as a (jax, torch) pair in ``dtype``."""
    jd = jnp.bfloat16 if dtype == BF16 else jnp.float32
    return jnp.asarray(x, jd), torch.from_numpy(x).to(dtype)


def _close(got, want, K):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32 == want.dtype
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 4 * np.sqrt(K) * U * scale


# --------------------------------------------------------------------------
# the ops the bf16 fit calls, against the reference's in interpret mode
# --------------------------------------------------------------------------

OP_SHAPES = [(130, 300, 20), (257, 129, 67), (5, 1000, 3)]


def test_both_packages_round_to_the_same_bf16():
    x = _randn(0, 1000) * np.float32(1e3)
    j, t = _pair(x)
    assert np.array_equal(np.asarray(j.astype(jnp.float32)), t.float().numpy())


@pytest.mark.parametrize("n,d,kt", OP_SHAPES)
def test_projections_match_reference(n, d, kt):
    (jx, tx), (jq, tq) = _pair(_randn(1, n, d)), _pair(_randn(2, d, kt))
    _close(tops.project(tx, tq), jops.project(jx, jq, interpret=True), d)
    _close(tops.stage_project(tx, tq), jops.stage_project(jx, jq, interpret=True), d)


@pytest.mark.parametrize("n,d,kt", OP_SHAPES)
def test_accumulations_match_reference(n, d, kt):
    (ja, ta), (jp, tp) = _pair(_randn(4, n, d)), _pair(_randn(5, n, kt))
    jp32, tp32 = _pair(_randn(5, n, kt), F32)
    _close(tops.accumulate_tn(ta, tp), jops.accumulate_tn(ja, jp, interpret=True), n)
    _close(tops.sweep_accumulate(ta, tp), jops.sweep_accumulate(ja, jp, interpret=True), n)
    _close(tops.sweep_accumulate(ta, tp32), jops.sweep_accumulate(ja, jp32, interpret=True), n)
    _close(tops.gram_accumulate(tp), jops.gram_accumulate(jp, interpret=True), n)
    for p in (tp, tp32):  # out= adds the same ΔY once
        acc = torch.from_numpy(_randn(6, d, kt))
        want = acc + tops.sweep_accumulate(ta, p)
        assert torch.equal(tops.sweep_accumulate(ta, p, out=acc), want)


# (n, da, db, k̃) → the schedule the rule resolves for both passes in bf16
CHUNK_SHAPES = {(130, 96, 200, 67): "recompute", (96, 1000, 900, 1030): "staged"}


@pytest.mark.parametrize("shape", list(CHUNK_SHAPES), ids=list(CHUNK_SHAPES.values()))
def test_chunk_updates_match_reference(shape):
    n, da, db, kt = shape
    (ja, ta), (jb, tb) = _pair(_randn(12, n, da)), _pair(_randn(13, n, db))
    (jQa, tQa), (jQb, tQb) = _pair(_randn(14, da, kt)), _pair(_randn(15, db, kt))
    for kind in ("power", "final"):
        assert tops.chunk_cost(kind, n, da, db, kt, dtype=BF16)["schedule"] == CHUNK_SHAPES[shape]
    got = tops.power_pass_chunk(ta, tb, tQa, tQb)
    want = jops.power_pass_chunk(ja, jb, jQa, jQb, interpret=True)
    for g, w, d in zip(got, want, (db, da)):
        _close(g, w, d + n)
    got = tops.final_pass_chunk(ta, tb, tQa, tQb)
    want = jops.final_pass_chunk(ja, jb, jQa, jQb, interpret=True)
    for g, w, d in zip(got, want, (da, db, max(da, db))):
        _close(g, w, d + n)


# --------------------------------------------------------------------------
# the bf16 sharded fit against the reference's, on 4 forced CPU devices
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
    cfg = RCCAConfig(k=r["k"], p=r["p"], q=1, lam_a=r["lam"], lam_b=r["lam"],
                     dtype=jnp.float32)
    f = dist_randomized_cca(A, B, cfg, jax.random.PRNGKey(0), mesh, microbatch=r["mb"],
                            engine=r["engine"], collective=r["collective"],
                            compute_dtype=jnp.bfloat16)
    res[r["key"]] = np.asarray(f.rho)
np.savez(out, **res)
"""


def _ref_key(mesh, engine, collective):
    """The reference run a port case is held against: the collective
    matters only to the kernels engine on a real model axis."""
    engine = "jnp" if engine == "torch" else engine
    if engine == "jnp" or mesh[2] == 1:
        collective = "fused"
    return f"{'x'.join(map(str, mesh))}_{engine}_{collective}"


def _omega():
    import jax

    ka, kb = jax.random.split(jax.random.PRNGKey(0))
    return (np.array(jax.random.normal(ka, (DA, KT), jnp.float32)),
            np.array(jax.random.normal(kb, (DB, KT), jnp.float32)))


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


def _cfg():
    return tr.RCCAConfig(k=K, p=P, q=1, lam_a=LAM, lam_b=LAM)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Every case of the port (1 × 1 × 1 in this process, the rest in one
    job of 4 ranks) and the reference's runs (a subprocess, started first
    so that the two overlap)."""
    A, B = PlantedCCAData(n=N, da=DA, db=DB, rank=8, seed=3, chunk=N).materialize()
    A, B = A.astype(np.float32), B.astype(np.float32)
    Qa, Qb = _omega()
    tmp = tmp_path_factory.mktemp("ref_bf16")
    np.savez(tmp / "inputs.npz", A=A, B=B)
    runs = {}
    for m, e, c in CASES:
        key = _ref_key(m, e, c)
        runs[key] = dict(key=key, mesh=m, engine=key.split("_")[1],
                         collective=key.split("_")[2], k=K, p=P, lam=LAM, mb=MB)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_allow_excess_precision=false")
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(tmp / "inputs.npz"),
                             str(tmp / "reference.npz"), json.dumps(list(runs.values()))],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port = {}
        calls, keys = [], []
        for case in CASES:
            m, e, c = case
            kw = dict(microbatch=MB, engine=e, collective=c, device="cpu", compute_dtype=BF16)
            if m == (1, 1, 1):
                res = td.dist_randomized_cca(A, B, _cfg(), Qa, Qb, Mesh(m), **kw)
                port[case] = ranks._to_host([res])
                continue
            world = int(np.prod(m))
            args = [(_block(A, m, r), _block(B, m, r), _cfg(), _block(Qa, m, r, False),
                     _block(Qb, m, r, False), ranks.OnMesh(m)) for r in range(world)]
            calls.append(ranks.Call(td.dist_randomized_cca, args, kw))
            keys.append(case)
        for key, res in zip(keys, ranks.run(calls, 4, timeout=SPAWN_TIMEOUT)):
            port[key] = res
        log = proc.communicate(timeout=REF_TIMEOUT)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, log[-4000:]
    return dict(port=port, ref=dict(np.load(tmp / "reference.npz")))


@pytest.mark.parametrize("case", CASES, ids=["x".join(map(str, c[0])) + f"-{c[1]}-{c[2]}"
                                            for c in CASES])
def test_bf16_fit_matches_reference(fits, case):
    m, e, c = case
    results = fits["port"][case]
    for r in results[1:]:  # finish runs on every rank on the same statistics
        np.testing.assert_array_equal(r.rho, results[0].rho)
    want = fits["ref"][_ref_key(m, e, c)]
    tol = (dict(rtol=0.05, atol=0.02) if c == "fused-int8ef" and e == "kernels" and m[2] > 1
           else dict(rtol=0, atol=1e-4))
    np.testing.assert_allclose(results[0].rho, want, **tol)
    assert np.all((results[0].rho >= 0) & (results[0].rho <= 1))


@pytest.mark.parametrize("mesh", MESHES, ids=["x".join(map(str, m)) for m in MESHES])
def test_bf16_unfused_is_fused_bitwise(fits, mesh):
    """The two collectives run the same bf16 products in the same order."""
    u, f = fits["port"][(mesh, "kernels", "unfused")], fits["port"][(mesh, "kernels", "fused")]
    for ru, rf in zip(u, f):
        for name in ("rho", "Xa", "Xb"):
            np.testing.assert_array_equal(getattr(ru, name), getattr(rf, name))


def test_bf16_is_not_the_f32_fit():
    """compute_dtype reaches the products: the bf16 fit's ρ moves from the
    f32 fit's, by less than 1e-3."""
    rng = np.random.default_rng(8)
    A, B = rng.standard_normal((N, DA)), rng.standard_normal((N, DB))
    Qa, Qb = rng.standard_normal((DA, KT)), rng.standard_normal((DB, KT))
    rho = {dt: td.dist_randomized_cca(A, B, _cfg(), Qa, Qb, Mesh((1, 1, 1)), microbatch=MB,
                                      engine="kernels", compute_dtype=dt, device="cpu").rho
           for dt in (F32, BF16)}
    gap = float((rho[F32] - rho[BF16]).abs().max())
    assert 0 < gap <= 1e-3


# --------------------------------------------------------------------------
# the dispatch table
# --------------------------------------------------------------------------

# entry point → the plain version its CPU path calls, with the operands
ENTRY_OF_REF = {
    "proj_stage_ref": "proj_stage", "matmul_nn_ref": "matmul_nn",
    "powerpass_sweep_ref": "powerpass_sweep", "matmul_tn_ref": "matmul_tn",
    "gram_sweep_ref": "gram_sweep", "projgram_ref": "projgram",
    "power_project_accumulate_ref": "power_project_accumulate",
}


def _called_forms(monkeypatch, fit):
    """(entry point, operand dtypes) of every kernel entry point ``fit()``
    reaches, recorded at the plain versions the CPU path calls (the
    outermost call only: a fused plain version calls the staged ones)."""
    seen, depth = set(), [0]
    for name, entry in ENTRY_OF_REF.items():
        fn = getattr(ref, name)

        def spy(*args, _fn=fn, _entry=entry):
            if depth[0] == 0:
                seen.add((_entry, tuple(a.dtype for a in args if isinstance(a, torch.Tensor))))
            depth[0] += 1
            try:
                return _fn(*args)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(ref, name, spy)
    fit()
    return seen


def test_every_form_the_bf16_fit_calls_has_a_kernel(monkeypatch):
    rng = np.random.default_rng(9)
    A, B = rng.standard_normal((N, DA)), rng.standard_normal((N, DB))
    Qa, Qb = rng.standard_normal((DA, KT)), rng.standard_normal((DB, KT))

    def fit():
        # a real model axis: one model rank's passes (the single products)
        _sharded_passes_in_process(A, B, Qa, Qb)
        # no model axis: the fit on one rank, then both schedules of the
        # chunk updates
        td.dist_randomized_cca(A, B, _cfg(), Qa, Qb, Mesh((1, 1, 1)), microbatch=MB,
                               engine="kernels", compute_dtype=BF16, device="cpu")
        a, b = torch.from_numpy(A).to(BF16), torch.from_numpy(B).to(BF16)
        qa, qb = torch.from_numpy(Qa).to(BF16), torch.from_numpy(Qb).to(BF16)
        for schedule in ("recompute", "staged"):
            tops.power_pass_chunk(a, b, qa, qb, schedule=schedule)
            tops.final_pass_chunk(a, b, qa, qb, schedule=schedule)

    seen = _called_forms(monkeypatch, fit)
    declared = {fn for fns in build.SIGNATURES.values() for fn in fns}
    # (f32, f32) sweeps: fused-int8ef's decoded sum of P is f32, in both packages
    want = {("proj_stage", (BF16, BF16)), ("matmul_nn", (BF16, BF16)),
            ("powerpass_sweep", (BF16, BF16)), ("powerpass_sweep", (BF16, F32)),
            ("powerpass_sweep", (F32, F32)),
            ("matmul_tn", (BF16, BF16)), ("matmul_tn", (F32, F32)), ("gram_sweep", (BF16,)),
            ("gram_sweep", (F32,)), ("projgram", (BF16, BF16)),
            ("power_project_accumulate", (BF16, BF16, BF16))}
    assert seen == want
    for entry, dtypes in seen:
        f = matmul.cuda_form(entry, *dtypes)
        assert f.fn in declared
        assert f.label == entry if set(dtypes) == {F32} else f.label.startswith(f"{entry}[bf16")


def _sharded_passes_in_process(A, B, Qa, Qb):
    """One model rank's passes under a real model axis, in this process: a
    stand-in mesh whose sums are the identity (the products are what is
    recorded here, not the values)."""
    class OneOfTwo:
        axis_names = ("pod", "data", "model")
        shape = {"pod": 1, "data": 1, "model": 2}

        def all_reduce(self, x, axes):
            return x

        def group(self, axes):
            return None

        def size(self, axes):
            return 1

    a, b, qa, qb = (torch.from_numpy(np.ascontiguousarray(x)).float()
                    for x in (A[:, :DA // 2], B[:, :DB // 2], Qa[:DA // 2], Qb[:DB // 2]))
    for collective in COLLECTIVES:
        kw = dict(mesh=OneOfTwo(), row_axes=("pod", "data"), col_axis="model", microbatch=MB,
                  compute_dtype=BF16, engine="kernels", collective=collective)
        td.power_pass_local(a, b, qa, qb, **kw)
        td.final_pass_local(a, b, qa, qb, **kw)


FORMS_OF = {e: len(next(iter(forms))) for e, forms in matmul.FORMS.items()}


@pytest.mark.parametrize("entry", sorted(FORMS_OF))
def test_every_other_form_raises(entry):
    dtypes = (F32, BF16, torch.float16, torch.float64)
    for combo in itertools.product(dtypes, repeat=FORMS_OF[entry]):
        if combo in matmul.FORMS[entry]:
            assert matmul.cuda_form(entry, *combo).fn == matmul.FORMS[entry][combo]
        else:
            with pytest.raises(TypeError, match=entry):
                matmul.cuda_form(entry, *combo)


def test_named_refusals():
    """f16, f64 and f32 A against a bf16 P have no kernel; every C function
    of the table is declared."""
    for bad in [(torch.float16, torch.float16), (torch.float64, torch.float64), (F32, BF16)]:
        with pytest.raises(TypeError):
            matmul.cuda_form("powerpass_sweep", *bad)
    declared = {fn for fns in build.SIGNATURES.values() for fn in fns}
    assert {fn for forms in matmul.FORMS.values() for fn in forms.values()} <= declared
    assert matmul.cuda_form("powerpass_sweep", BF16, F32).label == "powerpass_sweep[bf16,f32]"
    assert matmul.cuda_form("projgram", BF16, BF16).label == "projgram[bf16]"
    assert matmul.cuda_form("proj_stage", F32, F32).label == "proj_stage"


def test_form_checks_layout():
    x = torch.zeros(4, 6, dtype=BF16)
    with pytest.raises(ValueError, match="contiguous"):
        matmul.form("proj_stage", x.T, x)
    with pytest.raises(ValueError, match="2-D"):
        matmul.form("gram_sweep", torch.zeros(3, dtype=BF16))
    with pytest.raises(TypeError, match="float32"):
        matmul._check_out("powerpass_sweep[bf16]", torch.zeros(2, 2, dtype=BF16), (2, 2), x.device)


# --------------------------------------------------------------------------
# plans and the rule
# --------------------------------------------------------------------------


def test_bf16_plans_count_two_bytes_per_operand_element():
    (nn,) = plan.plan_proj_stage(8192, 2 ** 19, 2060, dtype=BF16)
    assert nn.kernel == "gemm_nn_bf16" and nn.grid == (17, 64)
    assert nn.flops == nn.tc_flops == 2 * 8192 * 2 ** 19 * 2060
    assert nn.bytes == 2 * (8192 * 2 ** 19 + 2 ** 19 * 2060) + 4 * 8192 * 2060
    (tn,) = plan.plan_powerpass_sweep(4096, 2 ** 18, 2060, accumulate=True, dtype=BF16)
    assert tn.kernel == "gemm_tn_bf16" and tn.tc_flops == tn.flops
    assert tn.bytes == 2 * (4096 * 2 ** 18 + 4096 * 2060) + 4 * 2 * 2 ** 18 * 2060
    (mixed,) = plan.plan_powerpass_sweep(8192, 2 ** 19, 2060, dtype=BF16, p_dtype=F32)
    assert mixed.kernel == "gemm_tn_bf16_f32" and mixed.tc_flops == 0
    assert mixed.bytes == 2 * 8192 * 2 ** 19 + 4 * (8192 * 2060 + 2 ** 19 * 2060)
    (g,) = plan.plan_gram_sweep(4096, 2060, dtype=BF16)
    assert g.kernel == "gemm_tn_bf16"  # both operands are P, each counted, as in f32
    assert g.bytes == 2 * 2 * 4096 * 2060 + 4 * 2060 * 2060
    (pg,) = plan.plan_projgram(8192, 2 ** 19, 970, dtype=BF16)
    assert pg.kernel == "projgram_bf16" and pg.tc_flops == 2 * 8192 * 2 ** 19 * 970
    assert pg.flops == pg.tc_flops + 2 * 8192 * 970 * 970
    assert pg.bytes == 2 * (8192 * 2 ** 19 + 2 ** 19 * 970) + 4 * (8192 * 970 + 970 * 970)
    (pa,) = plan.plan_power_project_accumulate(8192, 1024, 2 ** 19, 970, dtype=BF16)
    assert pa.kernel == "power_recompute_bf16"
    assert pa.bytes == 2 * (8192 * 2 ** 19 + 2 ** 19 * 970 + 8192 * 1024) + 4 * 1024 * 970
    stage, sweep = plan.plan_powerpass_staged(8192, 1024, 2 ** 19, 970, dtype=BF16)
    assert (stage.kernel, sweep.kernel) == ("gemm_nn_bf16", "gemm_tn_bf16_f32")
    # the rule charges a tensor-core FLOP at 67/989 of an f32 one
    assert plan.weighted_cost([nn]) == (nn.flops * 67 / 989, nn.bytes)
    assert plan.weighted_cost([mixed]) == plan.cost([mixed])
    with pytest.raises(TypeError):
        plan.plan_proj_stage(8, 8, 8, dtype=torch.float16)


D = 2 ** 19
# (n, da, db, k̃): the p = 2000 / p = 910 chunks at Europarl width, one
# model shard's microbatch of the sharded fit, the narrow power pair, and
# the smoke fit's chunk and microbatch
RULE_SHAPES = [(8192, D, D, 2060), (8192, D, D, 970), (4096, D // 2, D // 2, 2060),
               (8192, 1024, D, 970), (512, 256, 192, 32), (4096, 256, 192, 32)]


@pytest.fixture
def empty_autotune(monkeypatch, tmp_path):
    monkeypatch.setenv("RCCA_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))


@pytest.mark.parametrize("n,da,db,kt", RULE_SHAPES)
def test_bf16_rule_makes_the_reference_decisions(empty_autotune, n, da, db, kt):
    """The port's bf16 decisions equal the reference's bf16 decisions at
    every shape here (and its f32 ones): staged where there are several
    buckets, because recomputing multiplies the projection by the bucket
    count whether the tensor cores run it or not; recompute at one."""
    for d_out, d_in in [(da, db), (db, da)]:
        want = j_choose_power(n, d_out, d_in, kt, jnp.bfloat16)
        assert tk.choose_powerpass_schedule(n, d_out, d_in, kt, dtype=BF16) == want
        assert tk.choose_powerpass_schedule(n, d_out, d_in, kt, accumulate=True,
                                            dtype=BF16) == want
        assert want == ("recompute" if len(plan.buckets(d_out, kt)) == 1 else "staged")
    for d in (da, db):
        want = j_choose_gram(n, d, kt, jnp.bfloat16)
        assert tk.choose_projgram_schedule(n, d, kt, dtype=BF16) == want


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------


def test_launcher_dist_bf16_matches_the_api_call(capsys):
    rep = cca_fit.main(["--smoke", "--device", "cpu", "--mode", "dist", "--ranks", "4",
                        "--compute-dtype", "bfloat16"])
    out = capsys.readouterr().out
    assert "compute_dtype=bfloat16" in out
    assert all(r["compute_dtype"] == "bfloat16" for r in rep.ranks)
    api = cca_fit.fit_dist(smoke_config(), n_ranks=4, device="cpu", gather=True,
                           compute_dtype="bfloat16")
    assert api.mesh == rep.mesh == {"pod": 1, "data": 2, "model": 2}
    np.testing.assert_array_equal(rep.result.rho.numpy(), api.result.rho.numpy())
    f32 = cca_fit.fit_dist(smoke_config(), n_ranks=4, device="cpu")
    gap = float(np.abs(rep.result.rho.numpy() - f32.result.rho.numpy()).max())
    assert 0 < gap <= 1e-3


def test_launcher_runs_bf16_in_stream_mode_and_refuses_float16(capsys):
    rep = cca_fit.main(["--smoke", "--device", "cpu", "--compute-dtype", "bfloat16",
                        "--n-chunks", "2", "--q", "0"])
    assert "compute_dtype=bfloat16" in capsys.readouterr().out
    assert rep.n_chunks == 2 and rep.result.rho.shape == (smoke_config().rcca.k,)
    with pytest.raises(SystemExit):
        cca_fit.main(["--smoke", "--device", "cpu", "--compute-dtype", "float16"])
    with pytest.raises(ValueError, match="compute dtype"):
        cca_fit.fit_dist(smoke_config(), n_ranks=1, device="cpu", compute_dtype="float16")


# --------------------------------------------------------------------------
# on the card: the bf16 kernels (skips without CUDA)
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels are CUDA C++ with "
                    "no CPU mode (chip_smoke.py runs them on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,d,kt,da", [(333, 517, 67, 301), (200, 1000, 970, 129),
                                       (130, 4100, 2060, 517)])
def test_cuda_bf16_forms_match_plain_and_contracts(cuda_device, n, d, kt, da):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    x, q, a = (torch.randn(s, generator=g, device=cuda_device).to(BF16)
               for s in ((n, d), (d, kt), (n, da)))
    tk.reset_launch_counts()
    p32 = tk.proj_stage(x, q)
    p16 = p32.to(BF16)
    pairs = [(p32, ref.proj_stage_ref(x, q), d),
             (tk.powerpass_sweep(a, p32), ref.powerpass_sweep_ref(a, p32), n),
             (tk.powerpass_sweep(x, p16), ref.powerpass_sweep_ref(x, p16), n),
             (tk.gram_sweep(p16), ref.gram_sweep_ref(p16), n)]
    for got, want, K in pairs:
        assert float((got - want).abs().max() / want.abs().max()) <= 4 * K ** 0.5 * U
    assert tk.launch_counts() == {"proj_stage[bf16]": 1, "powerpass_sweep[bf16,f32]": 1,
                                  "powerpass_sweep[bf16]": 1, "gram_sweep[bf16]": 1}
    assert torch.equal(tk.matmul_nn(x, q), p32)
    assert torch.equal(tk.matmul_tn(x, p16), tk.powerpass_sweep(x, p16))
    assert torch.equal(tk.gram_sweep(p16), tk.matmul_tn(p16, p16))
    for rec, staged in [(tk.projgram(x, q, schedule="recompute"),
                         tk.projgram(x, q, schedule="staged")),
                        ((tk.power_project_accumulate(a, x, q, schedule="recompute"),),
                         (tk.power_project_accumulate(a, x, q, schedule="staged"),))]:
        for r, s in zip(rec, staged):
            assert torch.equal(r, s)
    with pytest.raises(TypeError):
        tk.powerpass_sweep(a.float(), p16)
    for schedule in ("staged", "recompute"):  # one set of forms under either schedule
        with pytest.raises(TypeError):
            tk.power_project_accumulate(a.float(), x, q, schedule=schedule)
