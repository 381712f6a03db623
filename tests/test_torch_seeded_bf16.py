"""The bf16 forms of the seeded kernels and the bf16 stream fit
(``RCCAConfig(dtype=torch.bfloat16)``), against the reference's.

- **Kernels.** ``proj_stage_seeded``, ``power_project_accumulate_seeded``,
  ``projgram_seeded`` and the seeded chunk updates on bf16 data (their
  plain versions on the CPU) against the reference's seeded Pallas
  kernels in interpret mode at ``q_dtype=jnp.bfloat16``, under both
  schedules, at ragged shapes.  Each package makes its own Ω from the
  same seed: f32 elements that differ by an ulp or two (``log`` and
  ``cos`` are rounded differently by the two packages) can round to bf16
  elements one bf16 ulp apart, rarely.  So each comparison is held to
  relative Frobenius ≤ 1e-5 (the f32 summation orders differ; bf16
  products are exact in f32 on both sides) plus the exact first-order
  effect of the two Ωs' difference, ‖|X|·|Ω_port − Ω_ref|‖ / ‖ref‖ (zero
  where the Ωs agree; for outputs further down the chain, the same bound
  carried through the absolute values).  The test asserts that every
  differing Ω element is one bf16 ulp and prints how many differ.
- **Fits.** Inside the port ``omega="seeded"`` is bitwise
  ``"seeded-materialized"`` at bf16, for q ∈ {0, 1}, centered and raw, on
  both engines; the port's bf16 stream fit (seeded, and materialized on
  the reference's own Ω) lies within 1e-4 in ρ of the reference's bf16
  stream fit (kernels engine, interpret mode), centered included — the
  centered one raised in the port before ``centered_Y`` / ``centered_CF``
  promoted Q to f32 as jnp does.
- **Dispatch, plans and the rule.** Every form the bf16 stream fit
  reaches has a ``FORMS`` row and a declared C function; the seeded bf16
  plans count 2 bytes per bf16 element and tensor-core FLOPs; the rule's
  bf16 seeded decisions are the reference's at the Europarl and smoke
  shapes.
- **Launcher.** ``cca_fit --compute-dtype bfloat16`` is bitwise the API
  call it stands for.
- **On the card** (skips without CUDA): the three seeded bf16 forms
  bitwise their materialized forms on the card's own bf16 Ω, within
  4·√K·u of the plain product on that Ω, and the bf16 generator bitwise
  the f32 one cast.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rcca as jr
from repro.exec import PassEngine as JPassEngine
from repro.exec import StackedChunks as JStacked
from repro.kernels import ops as jops
from repro.kernels import rand as jrand
from repro.kernels.powerpass import choose_powerpass_schedule as j_choose_power
from repro.kernels.powerpass import power_project_accumulate_seeded as j_power_seeded
from repro.kernels.powerpass import proj_stage_seeded as j_stage_seeded
from repro.kernels.projgram import choose_projgram_schedule as j_choose_gram
from repro.kernels.projgram import projgram_seeded as j_projgram_seeded
from repro_torch import kernels as tk
from repro_torch.configs.europarl_cca import smoke_config
from repro_torch.core import rcca as tr
from repro_torch.data import DevicePlantedChunks, PlantedCCAData
from repro_torch.exec import PassEngine, StackedChunks
from repro_torch.kernels import build, matmul, plan, rand, ref
from repro_torch.kernels import ops as tops
from repro_torch.launch import cca_fit

BF16, F32 = torch.bfloat16, torch.float32
RTOL = 1e-5
U = 2.0 ** -24
SEED_A, SEED_B = rand.omega_seeds(11)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(x):
    """The same numpy values as a bf16 (jax, torch) pair."""
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(BF16)


def _omegas(seed, d, kt):
    """(port Ω, reference Ω) in bf16, as f64 numpy, each package's own;
    asserts that every differing element is one bf16 ulp and prints the
    count."""
    t = rand.dense_omega(seed, d, kt, BF16, device="cpu")
    j = jrand.dense_omega(jnp.array(seed, jnp.uint32), d, kt, jnp.bfloat16)
    tb = t.view(torch.int16).numpy().astype(np.int32)
    jb = np.asarray(j).view(np.int16).astype(np.int32)
    differ = int((tb != jb).sum())
    print(f"Ω({seed}) ({d}, {kt}) bf16: {differ} of {d * kt} elements differ")
    # same sign (an element never crosses 0 by an ulp here) and one bf16 ulp apart
    assert np.all(np.abs(tb - jb) <= 1) and np.all((tb < 0) == (jb < 0))
    return t.double().numpy(), np.asarray(j.astype(jnp.float32), np.float64)


def _hold(got, want, slack):
    """relative Frobenius ≤ RTOL plus ``slack``, the first-order effect of
    the Ω difference relative to ‖want‖."""
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    norm = np.linalg.norm(want)
    assert np.linalg.norm(got - want) / norm <= RTOL + slack / norm


def _abs(x):
    return np.abs(np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float64))


# --------------------------------------------------------------------------
# the kernels against the reference's, in interpret mode
# --------------------------------------------------------------------------

# (n, d, k̃): ragged; d = 9001 gives one Ω element one bf16 ulp apart
STAGE_SHAPES = [(130, 300, 67), (77, 9001, 67), (256, 1024, 256)]


@pytest.mark.parametrize("n,d,kt", STAGE_SHAPES)
def test_proj_stage_seeded_bf16_matches_reference(n, d, kt):
    jx, tx = _pair(_randn(0, n, d))
    want = j_stage_seeded(jx, jnp.array(SEED_A, jnp.uint32), kt=kt, q_dtype=jnp.bfloat16,
                          interpret=True)
    got = tk.proj_stage_seeded(tx, SEED_A, kt)
    assert got.dtype == F32
    om_t, om_j = _omegas(SEED_A, d, kt)
    _hold(got, want, np.linalg.norm(_abs(tx) @ np.abs(om_t - om_j)))


# (n, da, db, k̃): ragged; ΔYa bucketed (the rule stages it); db = 9001
POWER_SHAPES = [(130, 96, 200, 67), (64, 129, 9001, 33), (256, 2048, 128, 512)]


@pytest.mark.parametrize("schedule", ["staged", "recompute"])
@pytest.mark.parametrize("n,da,db,kt", POWER_SHAPES)
def test_power_project_accumulate_seeded_bf16_matches_reference(n, da, db, kt, schedule):
    (ja, ta), (jb, tb) = _pair(_randn(1, n, da)), _pair(_randn(2, n, db))
    want = j_power_seeded(ja, jb, jnp.array(SEED_B, jnp.uint32), kt=kt, q_dtype=jnp.bfloat16,
                          schedule=schedule, interpret=True)
    got = tk.power_project_accumulate_seeded(ta, tb, SEED_B, kt, schedule=schedule)
    om_t, om_j = _omegas(SEED_B, db, kt)
    _hold(got, want, np.linalg.norm(_abs(ta).T @ (_abs(tb) @ np.abs(om_t - om_j))))


# (n, d, k̃): ragged; two C buckets (k̃ = 1100); d = 9001
GRAM_SHAPES = [(130, 200, 67), (77, 9001, 33), (130, 96, 1100)]


@pytest.mark.parametrize("schedule", ["staged", "recompute"])
@pytest.mark.parametrize("n,d,kt", GRAM_SHAPES)
def test_projgram_seeded_bf16_matches_reference(n, d, kt, schedule):
    jx, tx = _pair(_randn(3, n, d))
    want = j_projgram_seeded(jx, jnp.array(SEED_A, jnp.uint32), kt=kt, q_dtype=jnp.bfloat16,
                             schedule=schedule, interpret=True)
    got = tk.projgram_seeded(tx, SEED_A, kt, schedule=schedule)
    om_t, om_j = _omegas(SEED_A, d, kt)
    dP = _abs(tx) @ np.abs(om_t - om_j)  # |ΔP| to first order
    _hold(got[0], want[0], np.linalg.norm(dP))
    _hold(got[1], want[1], 2 * np.linalg.norm(_abs(got[0]).T @ dP))


@pytest.mark.parametrize("schedule", ["staged", "recompute"])
def test_seeded_chunk_updates_bf16_match_reference(schedule):
    n, da, db, kt = 130, 96, 9001, 67
    (ja, ta), (jb, tb) = _pair(_randn(4, n, da)), _pair(_randn(5, n, db))
    js = (jnp.array(SEED_A, jnp.uint32), jnp.array(SEED_B, jnp.uint32))
    (oa_t, oa_j), (ob_t, ob_j) = _omegas(SEED_A, da, kt), _omegas(SEED_B, db, kt)
    dPa, dPb = _abs(ta) @ np.abs(oa_t - oa_j), _abs(tb) @ np.abs(ob_t - ob_j)
    want = jops.power_pass_chunk_seeded(ja, jb, *js, kt=kt, q_dtype=jnp.bfloat16,
                                        schedule=schedule, interpret=True)
    got = tops.power_pass_chunk_seeded(ta, tb, SEED_A, SEED_B, kt=kt, schedule=schedule)
    _hold(got[0], want[0], np.linalg.norm(_abs(ta).T @ dPb))
    _hold(got[1], want[1], np.linalg.norm(_abs(tb).T @ dPa))
    want = jops.final_pass_chunk_seeded(ja, jb, *js, kt=kt, q_dtype=jnp.bfloat16,
                                        schedule=schedule, interpret=True)
    got = tops.final_pass_chunk_seeded(ta, tb, SEED_A, SEED_B, kt=kt, schedule=schedule)
    Pa, Pb = (_abs(ref.proj_stage_seeded_ref(x, s, kt)) for x, s in ((ta, SEED_A),
                                                                     (tb, SEED_B)))
    _hold(got[0], want[0], 2 * np.linalg.norm(Pa.T @ dPa))
    _hold(got[1], want[1], 2 * np.linalg.norm(Pb.T @ dPb))
    _hold(got[2], want[2], np.linalg.norm(dPa.T @ Pb) + np.linalg.norm(Pa.T @ dPb))


def test_seeded_bf16_on_cpu_is_the_materialized_bf16_update():
    """On the CPU the seeded bf16 updates are the materialized ones fed the
    bf16 ``dense_omega`` (f32 made, rounded once), bit for bit, and launch
    nothing; Ω is made in the data's dtype."""
    a, b = torch.from_numpy(_randn(6, 64, 40)).to(BF16), torch.from_numpy(_randn(7, 64, 30)).to(BF16)
    Qa = rand.dense_omega(SEED_A, 40, 9, BF16, device="cpu")
    Qb = rand.dense_omega(SEED_B, 30, 9, BF16, device="cpu")
    assert torch.equal(Qa, rand.omega_tile(SEED_A, 40, 9, device="cpu").to(BF16))
    tk.reset_launch_counts()
    for schedule in ("staged", "recompute"):
        pairs = [(tops.power_pass_chunk_seeded(a, b, SEED_A, SEED_B, kt=9, schedule=schedule),
                  tops.power_pass_chunk(a, b, Qa, Qb, schedule=schedule)),
                 (tops.final_pass_chunk_seeded(a, b, SEED_A, SEED_B, kt=9, schedule=schedule),
                  tops.final_pass_chunk(a, b, Qa, Qb, schedule=schedule))]
        for seeded, mat in pairs:
            for s, m in zip(seeded, mat):
                assert torch.equal(s, m)
    assert torch.equal(tops.stage_project_seeded(a, SEED_A, kt=9), ref.proj_stage_ref(a, Qa))
    assert tk.launch_counts() == {}


def test_device_chunks_cast_each_view():
    """A bf16 chunk is the f32 chunk rounded once, view by view."""
    kw = dict(rank=4, seed=2, chunk=16, device="cpu")
    a32, b32 = DevicePlantedChunks(40, 24, 20, **kw).get_chunk(1)
    a16, b16 = DevicePlantedChunks(40, 24, 20, dtype=BF16, **kw).get_chunk(1)
    assert a16.dtype == b16.dtype == BF16
    assert torch.equal(a16, a32.to(BF16)) and torch.equal(b16, b32.to(BF16))
    a16c, b16c = DevicePlantedChunks(40, 24, 20, dtype=BF16, **kw).get_chunk(
        1, slice(0, 12), slice(10, 20))
    assert torch.equal(a16c, a16[:, :12]) and torch.equal(b16c, b16[:, 10:])


# --------------------------------------------------------------------------
# fits
# --------------------------------------------------------------------------

NC, CHUNK, DA, DB, K, P = 4, 128, 64, 48, 4, 4


@pytest.fixture(scope="module")
def chunks():
    d = PlantedCCAData(n=NC * CHUNK, da=DA, db=DB, rank=8, seed=1, chunk=CHUNK)
    A, B = (x.astype(np.float32) for x in d.materialize())
    return A.reshape(NC, CHUNK, DA), B.reshape(NC, CHUNK, DB)


def _tcfg(q, center):
    return tr.RCCAConfig(k=K, p=P, q=q, nu=0.01, center=center, dtype=BF16)


def _fit(chunks, omega, q, center, engine="kernels", seed=5):
    return PassEngine(_tcfg(q, center), engine=engine, device="cpu", omega=omega).run(
        StackedChunks(*chunks), seed=seed)


@pytest.mark.parametrize("engine", ["kernels", "torch"])
@pytest.mark.parametrize("center", [False, True], ids=["raw", "centered"])
@pytest.mark.parametrize("q", [0, 1])
def test_bf16_seeded_fit_is_bitwise_seeded_materialized(chunks, q, center, engine):
    got = _fit(chunks, "seeded", q, center, engine)
    want = _fit(chunks, "seeded-materialized", q, center, engine)
    assert got.Qa.dtype == BF16
    for f in ("Xa", "Xb", "rho", "Qa", "Qb"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _ref_fit(chunks, q, center, omega, engine="kernels", seed=5):
    jcfg = jr.RCCAConfig(k=K, p=P, q=q, nu=0.01, center=center, dtype=jnp.bfloat16)
    Ac, Bc = (jnp.asarray(x, jnp.bfloat16) for x in chunks)
    return JPassEngine(jcfg, engine=engine, omega=omega).run(JStacked(Ac, Bc),
                                                             jax.random.PRNGKey(seed))


@pytest.mark.parametrize("center", [False, True], ids=["raw", "centered"])
@pytest.mark.parametrize("q", [0, 1])
def test_bf16_seeded_fit_matches_reference(chunks, q, center):
    """Each package makes its own bf16 Ω from the integer seed."""
    want = _ref_fit(chunks, q, center, "seeded")
    got = _fit(chunks, "seeded", q, center)
    assert np.max(np.abs(got.rho.numpy() - np.asarray(want.rho))) <= 1e-4


def _ref_omega(seed):
    """The reference's materialized f32 Ω for ``seed`` (``init_Q``'s draw);
    each side rounds it to bf16 once."""
    ka, kb = jax.random.split(jax.random.PRNGKey(seed))
    return (np.array(jax.random.normal(ka, (DA, K + P), jnp.float32)),
            np.array(jax.random.normal(kb, (DB, K + P), jnp.float32)))


@pytest.mark.parametrize("engine", ["kernels", "torch"])
@pytest.mark.parametrize("center", [False, True], ids=["raw", "centered"])
def test_bf16_materialized_fit_matches_reference(chunks, center, engine):
    """The port fed the reference's own Ω.  Centered, this raised in the
    port (``centered_Y`` multiplied the f32 means by a bf16 Q)."""
    want = _ref_fit(chunks, 1, center, "materialized", seed=3)
    Qa, Qb = _ref_omega(3)
    got = tr.randomized_cca_streaming(*chunks, _tcfg(1, center), Qa, Qb, engine=engine,
                                      device="cpu")
    assert got.Qa.dtype == BF16
    assert np.max(np.abs(got.rho.numpy() - np.asarray(want.rho))) <= 1e-4


def test_centering_promotes_a_bf16_q_and_keeps_f32_bits():
    """The rank-one terms take Q promoted to f32: at bf16 they equal the
    same terms on Q widened, and at f32 the promotion changes no bit."""
    rng = np.random.default_rng(4)
    Ya, Yb = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in
              ((DA, 8), (DB, 8)))
    s = tr.PowerStats(Ya=Ya, Yb=Yb, sa=torch.from_numpy(_randn(8, DA)),
                      sb=torch.from_numpy(_randn(9, DB)), n=torch.tensor(37.0),
                      tr_a=torch.tensor(1.0), tr_b=torch.tensor(1.0))
    Qa, Qb = (torch.from_numpy(_randn(i, d, 8)) for i, d in ((10, DA), (11, DB)))
    for got, want in zip(tr.centered_Y(s, Qa.to(BF16), Qb.to(BF16), True),
                         tr.centered_Y(s, Qa.to(BF16).float(), Qb.to(BF16).float(), True)):
        assert got.dtype == F32 and torch.equal(got, want)
    n = torch.clamp(s.n, min=1.0)
    assert torch.equal(tr.centered_Y(s, Qa, Qb, True)[0],
                       s.Ya - n * torch.outer(s.sa / n, (s.sb / n) @ Qb))
    f = tr.FinalStats(Ca=Ya[:8], Cb=Yb[:8], F=Ya[8:16], sa=s.sa, sb=s.sb, n=s.n,
                      tr_a=s.tr_a, tr_b=s.tr_b)
    for got, want in zip(tr.centered_CF(f, Qa.to(BF16), Qb.to(BF16), True),
                         tr.centered_CF(f, Qa.to(BF16).float(), Qb.to(BF16).float(), True)):
        assert got.dtype == F32 and torch.equal(got, want)


# --------------------------------------------------------------------------
# dispatch, plans and the rule
# --------------------------------------------------------------------------

SEEDED_REFS = {"proj_stage_seeded_ref": "proj_stage_seeded",
               "projgram_seeded_ref": "projgram_seeded",
               "power_project_accumulate_seeded_ref": "power_project_accumulate_seeded"}
PLAIN_REFS = {"proj_stage_ref": "proj_stage", "powerpass_sweep_ref": "powerpass_sweep",
              "gram_sweep_ref": "gram_sweep", "matmul_tn_ref": "matmul_tn",
              "projgram_ref": "projgram",
              "power_project_accumulate_ref": "power_project_accumulate"}


def test_every_form_the_bf16_stream_fit_reaches_has_a_kernel(monkeypatch, chunks):
    """(entry point, operand dtypes) of every kernel entry point
    the bf16 stream fit reaches — each Ω mode, centered, then both
    schedules of the seeded and materialized chunk updates — recorded at
    the plain versions the CPU path calls (the outermost call only)."""
    seen, depth = set(), [0]
    for table in (SEEDED_REFS, PLAIN_REFS):
        for name, entry in table.items():
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
    for omega in tr.OMEGA_MODES:
        for q in (0, 1):
            _fit(chunks, omega, q, True)
    a, b = (torch.from_numpy(np.ascontiguousarray(x[0])).to(BF16) for x in chunks)
    qa, qb = (rand.dense_omega(s, d, 8, BF16, device="cpu") for s, d in ((SEED_A, DA),
                                                                          (SEED_B, DB)))
    for schedule in ("staged", "recompute"):
        tops.power_pass_chunk_seeded(a, b, SEED_A, SEED_B, kt=8, schedule=schedule)
        tops.final_pass_chunk_seeded(a, b, SEED_A, SEED_B, kt=8, schedule=schedule)
        tops.power_pass_chunk(a, b, qa, qb, schedule=schedule)
        tops.final_pass_chunk(a, b, qa, qb, schedule=schedule)
    want = {("proj_stage_seeded", (BF16,)), ("projgram_seeded", (BF16,)),
            ("power_project_accumulate_seeded", (BF16, BF16)),
            ("proj_stage", (BF16, BF16)), ("projgram", (BF16, BF16)),
            ("power_project_accumulate", (BF16, BF16, BF16)),
            ("powerpass_sweep", (BF16, F32)), ("gram_sweep", (F32,)),
            ("matmul_tn", (F32, F32))}
    assert seen == want
    declared = {fn for fns in build.SIGNATURES.values() for fn in fns}
    short = {BF16: "bf16", F32: "f32"}
    for entry, dtypes in seen:
        f = matmul.cuda_form(entry, *dtypes)
        assert f.fn in declared
        names = ",".join(dict.fromkeys(short[d] for d in dtypes))
        assert f.label == (entry if names == "f32" else f"{entry}[{names}]")
    assert matmul.cuda_form("omega_fill", BF16) == ("omega_fill_bf16", "omega_fill[bf16]")


def test_seeded_bf16_plans_count_two_bytes_per_element():
    n, d, kt = 8192, 2 ** 19, 2060
    stage = plan.plan_proj_stage_seeded(n, d, kt, dtype=BF16)
    assert len(stage) == 2 * d // plan.SEEDED_SLAB
    assert [p.kernel for p in stage[:4]] == ["omega_fill_bf16", "gemm_nn_bf16"] * 2
    fill, first, _, second = stage[:4]
    assert fill.bytes == 2 * plan.SEEDED_SLAB * kt and fill.flops == 0
    slab = plan.SEEDED_SLAB
    assert first.bytes == 2 * (n * slab + slab * kt) + 4 * n * kt
    assert second.bytes == 2 * (n * slab + slab * kt) + 4 * 2 * n * kt  # P read and written
    assert sum(p.tc_flops for p in stage) == sum(p.flops for p in stage) == 2 * n * d * kt
    # the fused seeded launches: the last slab's, per bucket
    (*_, last) = plan.plan_projgram_seeded(n, d, 970, dtype=BF16)
    assert last.kernel == "projgram_bf16" and last.tc_flops == 2 * n * slab * 970
    assert last.bytes == 2 * (n * slab + slab * 970) + 4 * (2 * n * 970 + 970 * 970)
    pa = plan.plan_power_project_accumulate_seeded(n, 1024, d, 970, accumulate=True,
                                                   dtype=BF16)
    assert pa[-1].kernel == "power_recompute_bf16"
    assert pa[-1].bytes == 2 * (n * slab + slab * 970 + n * 1024) + 4 * (n * 970 + 2 * 1024 * 970)
    assert plan.cost(pa)[0] == plan.cost(plan.plan_power_project_accumulate_seeded(
        n, 1024, d, 970, accumulate=True))[0]
    # f32 plans keep their bytes; bf16 halves the operand bytes of the stage
    f32_stage = plan.plan_proj_stage_seeded(n, d, kt)
    assert f32_stage[0].bytes == 2 * fill.bytes and f32_stage[0].kernel == "omega_fill"
    # staged: the bf16 seeded stage, then the f32 P's sweep / Gram
    *_, sweep = plan.plan_powerpass_staged(n, d, d, kt, seeded=True, dtype=BF16)
    assert sweep.kernel == "gemm_tn_bf16_f32"
    *_, gram = plan.plan_projgram_staged(n, d, kt, seeded=True, dtype=BF16)
    assert gram.kernel == "gemm_tn_f32"


D = 2 ** 19
# (n, da, db, k̃): the p = 2000 / p = 910 chunks at Europarl width, the
# narrow power pair, and the smoke fit's chunk
RULE_SHAPES = [(8192, D, D, 2060), (8192, D, D, 970), (8192, 1024, D, 970), (512, 256, 192, 32)]


@pytest.fixture
def empty_autotune(monkeypatch, tmp_path):
    monkeypatch.setenv("RCCA_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))


@pytest.mark.parametrize("n,da,db,kt", RULE_SHAPES)
def test_bf16_seeded_rule_makes_the_reference_decisions(empty_autotune, n, da, db, kt):
    """The reference's seeded entry points ask the same rule as its
    materialized ones, on the data's dtype."""
    for d_out, d_in in [(da, db), (db, da)]:
        want = j_choose_power(n, d_out, d_in, kt, jnp.bfloat16)
        assert tk.choose_powerpass_schedule(n, d_out, d_in, kt, seeded=True, accumulate=True,
                                            dtype=BF16) == want
    for d in (da, db):
        want = j_choose_gram(n, d, kt, jnp.bfloat16)
        assert tk.choose_projgram_schedule(n, d, kt, seeded=True, dtype=BF16) == want
    for kind in ("power", "final"):
        cost = tops.chunk_cost(kind, n, da, db, kt, seeded=True, dtype=BF16)
        assert cost["schedule"] in ("recompute", "staged", "recompute/staged")
        assert cost["bytes"] < tops.chunk_cost(kind, n, da, db, kt, seeded=True)["bytes"]


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------


@pytest.mark.parametrize("omega", ["seeded", "seeded-materialized", "materialized"])
def test_launcher_bf16_stream_is_the_api_call(capsys, omega):
    argv = ["--smoke", "--device", "cpu", "--compute-dtype", "bfloat16", "--omega", omega,
            "--n-chunks", "2", "--center"]
    rep = cca_fit.main(argv)
    out = capsys.readouterr().out
    assert "compute_dtype=bfloat16" in out and f"omega={omega}" in out
    wl = smoke_config()
    wl = dataclasses.replace(wl, rcca=dataclasses.replace(wl.rcca, dtype=BF16, center=True))
    api = cca_fit.fit(wl, device="cpu", n_chunks=2, omega=omega)
    assert rep.pass_schedules == api.pass_schedules == ["recompute", "recompute"]
    for f in ("Xa", "Xb", "rho"):
        assert torch.equal(getattr(rep.result, f), getattr(api.result, f)), f
    assert rep.result.Qa.dtype == BF16


# --------------------------------------------------------------------------
# on the card (skips without CUDA)
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels are CUDA C++ with "
                    "no CPU mode (chip_smoke.py runs them on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,d,kt,da", [(333, 9001, 67, 301), (130, 4100, 3, 517),
                                       (200, 8192, 1100, 129)])
def test_cuda_seeded_bf16_forms_are_their_materialized_forms(cuda_device, n, d, kt, da):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    x, a = (torch.randn(s, generator=g, device=cuda_device).to(BF16) for s in ((n, d), (n, da)))
    omega = rand.dense_omega(SEED_A, d, kt, BF16, device=cuda_device)
    assert torch.equal(omega, rand.omega_fill(SEED_A, d, kt, device=cuda_device).to(BF16))
    tk.reset_launch_counts()
    p = tk.proj_stage_seeded(x, SEED_A, kt)
    assert tk.launch_counts() == {"proj_stage_seeded[bf16]": 1}
    assert torch.equal(p, tk.proj_stage(x, omega))
    want = ref.proj_stage_ref(x, omega)
    assert float((p - want).abs().max() / want.abs().max()) <= 4 * d ** 0.5 * U
    for schedule in ("recompute", "staged"):
        for s, m in zip(tk.projgram_seeded(x, SEED_A, kt, schedule=schedule),
                        tk.projgram(x, omega, schedule=schedule)):
            assert torch.equal(s, m)
        assert torch.equal(tk.power_project_accumulate_seeded(a, x, SEED_A, kt, schedule=schedule),
                           tk.power_project_accumulate(a, x, omega, schedule=schedule))
