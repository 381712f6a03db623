"""The recompute schedule of the port against the reference's, and the
schedule rule that chooses it.

Kernel level: the port's four fused entry points (``projgram``,
``projgram_seeded``, ``power_project_accumulate`` and its seeded form;
their plain versions on the CPU) against the reference's Pallas kernels
in interpret mode under ``schedule="recompute"``, at ragged shapes and at
shapes the reference splits into several buckets.  Tolerance: relative
Frobenius error ≤ 1e-5 in f32 — the two sides sum in different orders,
and the seeded Ω of the two packages differ by at most 4 ulp
(``test_torch_rand.py``).

Rule level: the port's ``choose_*_schedule`` at the Europarl and smoke
shapes of the p = 910 / p = 2000 fits make the reference's decisions
(empty autotune cache), and ``chunk_cost`` reports them.

Fit level: a p = 910 fit (k̃ = 970, whose final pass recomputes) at
narrow widths lies within 1e-4 in ρ of the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rcca as jr
from repro.kernels import ops as jops
from repro.kernels.powerpass import choose_powerpass_schedule as j_choose_power
from repro.kernels.powerpass import power_project_accumulate as j_ppa
from repro.kernels.powerpass import power_project_accumulate_seeded as j_ppa_seeded
from repro.kernels.projgram import choose_projgram_schedule as j_choose_gram
from repro.kernels.projgram import projgram as j_projgram
from repro.kernels.projgram import projgram_seeded as j_projgram_seeded
from repro_torch import kernels as tk
from repro_torch.core import rcca as tr
from repro_torch.data import PlantedCCAData
from repro_torch.exec import PassEngine, StackedChunks
from repro_torch.kernels import ops as tops
from repro_torch.kernels import plan, rand
from repro_torch.launch import cca_fit

RTOL = 1e-5
SEED_A, SEED_B = rand.omega_seeds(3)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _j(seed):
    return jnp.array(seed, jnp.uint32)


def _t(x):
    return torch.from_numpy(x)


# --------------------------------------------------------------------------
# the four fused entry points against the reference's recompute kernels
# --------------------------------------------------------------------------

# (n, d, k̃, block_c): ragged; one bucket; three C buckets in the reference
PROJGRAM_SHAPES = [(130, 300, 67, None), (77, 129, 1, None), (200, 260, 300, 128)]
# (n, da, db, k̃, block_da): ragged; one bucket; three ΔY buckets in the reference
POWER_SHAPES = [(130, 96, 200, 67, None), (77, 129, 61, 33, None), (150, 300, 90, 40, 128)]


@pytest.mark.parametrize("n,d,kt,block_c", PROJGRAM_SHAPES)
def test_projgram_recompute_matches_reference(n, d, kt, block_c):
    x, q = _randn(0, n, d), _randn(1, d, kt)
    want = j_projgram(jnp.asarray(x), jnp.asarray(q), block_c=block_c, schedule="recompute",
                      interpret=True)
    got = tk.projgram(_t(x), _t(q), schedule="recompute")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= RTOL


@pytest.mark.parametrize("n,d,kt,block_c", PROJGRAM_SHAPES)
def test_projgram_seeded_recompute_matches_reference(n, d, kt, block_c):
    x = _randn(2, n, d)
    want = j_projgram_seeded(jnp.asarray(x), _j(SEED_A), kt=kt, block_c=block_c,
                             schedule="recompute", interpret=True)
    got = tk.projgram_seeded(_t(x), SEED_A, kt, schedule="recompute")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= RTOL


@pytest.mark.parametrize("n,da,db,kt,block_da", POWER_SHAPES)
def test_power_project_accumulate_recompute_matches_reference(n, da, db, kt, block_da):
    a, b, q = _randn(3, n, da), _randn(4, n, db), _randn(5, db, kt)
    want = j_ppa(jnp.asarray(a), jnp.asarray(b), jnp.asarray(q), block_da=block_da,
                 schedule="recompute", interpret=True)
    got = tk.power_project_accumulate(_t(a), _t(b), _t(q), schedule="recompute")
    assert got.shape == want.shape
    assert _rel(got, want) <= RTOL
    # out= adds the same ΔY into the accumulator once
    acc = _t(_randn(6, da, kt))
    into = tk.power_project_accumulate(_t(a), _t(b), _t(q), schedule="recompute",
                                       out=acc.clone())
    assert torch.equal(into, acc + got)


@pytest.mark.parametrize("n,da,db,kt,block_da", POWER_SHAPES)
def test_power_project_accumulate_seeded_recompute_matches_reference(n, da, db, kt, block_da):
    a, b = _randn(7, n, da), _randn(8, n, db)
    want = j_ppa_seeded(jnp.asarray(a), jnp.asarray(b), _j(SEED_B), kt=kt, block_da=block_da,
                        schedule="recompute", interpret=True)
    got = tk.power_project_accumulate_seeded(_t(a), _t(b), SEED_B, kt, schedule="recompute")
    assert got.shape == want.shape
    assert _rel(got, want) <= RTOL


def test_schedules_agree_bitwise_on_cpu_and_launch_nothing():
    """On the CPU both schedules are the plain versions, so they agree
    bit for bit, and no kernel is launched."""
    a, b = _t(_randn(9, 64, 40)), _t(_randn(10, 64, 30))
    q = _t(_randn(11, 30, 9))
    tk.reset_launch_counts()
    for fn, args in [(tk.projgram, (b, q)), (tk.projgram_seeded, (b, SEED_A, 9)),
                     (tk.power_project_accumulate, (a, b, q)),
                     (tk.power_project_accumulate_seeded, (a, b, SEED_B, 9))]:
        rec, staged = fn(*args, schedule="recompute"), fn(*args, schedule="staged")
        for r, s in zip(rec if isinstance(rec, tuple) else (rec,),
                        staged if isinstance(staged, tuple) else (staged,)):
            assert torch.equal(r, s)
    assert tk.launch_counts() == {}
    with pytest.raises(ValueError, match="unknown schedule"):
        tk.projgram(b, q, schedule="fused")


# --------------------------------------------------------------------------
# the per-chunk updates against the reference's, per schedule
# --------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["recompute", "staged", None])
@pytest.mark.parametrize("n,da,db,kt", [(130, 96, 200, 67), (64, 300, 40, 1100)])
def test_chunk_updates_match_reference(n, da, db, kt, schedule):
    a, b = _randn(12, n, da), _randn(13, n, db)
    Qa, Qb = _randn(14, da, kt), _randn(15, db, kt)
    ja, jb, jQa, jQb = (jnp.asarray(v) for v in (a, b, Qa, Qb))
    pairs = [
        (tops.power_pass_chunk(_t(a), _t(b), _t(Qa), _t(Qb), schedule=schedule),
         jops.power_pass_chunk(ja, jb, jQa, jQb, schedule=schedule, interpret=True)),
        (tops.final_pass_chunk(_t(a), _t(b), _t(Qa), _t(Qb), schedule=schedule),
         jops.final_pass_chunk(ja, jb, jQa, jQb, schedule=schedule, interpret=True)),
        (tops.power_pass_chunk_seeded(_t(a), _t(b), SEED_A, SEED_B, kt=kt, schedule=schedule),
         jops.power_pass_chunk_seeded(ja, jb, _j(SEED_A), _j(SEED_B), kt=kt,
                                      q_dtype=jnp.float32, schedule=schedule,
                                      interpret=True)),
        (tops.final_pass_chunk_seeded(_t(a), _t(b), SEED_A, SEED_B, kt=kt, schedule=schedule),
         jops.final_pass_chunk_seeded(ja, jb, _j(SEED_A), _j(SEED_B), kt=kt,
                                      q_dtype=jnp.float32, schedule=schedule,
                                      interpret=True)),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert _rel(g, w) <= RTOL


# --------------------------------------------------------------------------
# the schedule rule
# --------------------------------------------------------------------------

D = 2**19
# (n, da, db, k̃): the p = 2000 and p = 910 fits' chunks at Europarl width,
# and the smoke fit's chunk
RULE_SHAPES = [(8192, D, D, 2060), (8192, D, D, 970), (512, 256, 192, 32)]
WANT = {2060: ("staged", "staged"), 970: ("staged", "recompute"),
        32: ("recompute", "recompute")}  # (power pass, final pass)


@pytest.fixture
def empty_autotune(monkeypatch, tmp_path):
    monkeypatch.setenv("RCCA_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))


@pytest.mark.parametrize("n,da,db,kt", RULE_SHAPES)
def test_schedule_rule_makes_the_reference_decisions(empty_autotune, n, da, db, kt):
    power, final = WANT[kt]
    for d_out, d_in in [(da, db), (db, da)]:
        assert j_choose_power(n, d_out, d_in, kt, jnp.float32) == power
        assert tk.choose_powerpass_schedule(n, d_out, d_in, kt) == power
        # the engine's form (ΔY added into Y) and the seeded form decide alike
        assert tk.choose_powerpass_schedule(n, d_out, d_in, kt, accumulate=True) == power
        assert tk.choose_powerpass_schedule(n, d_out, d_in, kt, seeded=True) == power
    for d in (da, db):
        assert j_choose_gram(n, d, kt, jnp.float32) == final
        assert tk.choose_projgram_schedule(n, d, kt) == final
        assert tk.choose_projgram_schedule(n, d, kt, seeded=True) == final
    for kind, want in [("power", power), ("final", final)]:
        for seeded in (False, True):
            assert tops.chunk_cost(kind, n, da, db, kt, seeded=seeded)["schedule"] == want


def test_bucket_counts_at_the_motivating_shapes():
    """The recompute's one-bucket condition is the reference's: 2^20
    accumulator elements at the 128-column tile.  The port's buckets are
    uniform (the reference's are powers of two), so past one bucket the
    counts differ: 6 C buckets at k̃ = 2060 against its 17."""
    assert plan.ONE_BUCKET_ELEMS == 1 << 20
    assert len(plan.buckets(970, 970)) == 1  # k̃p = 1024: C = 2^20 elements
    assert len(plan.buckets(1025, 1025)) == 2
    assert len(plan.buckets(2060, 2060)) == 6
    assert len(plan.buckets(D, 970)) == 512  # as the reference's 512
    assert len(plan.buckets(256, 32)) == 1
    assert plan.buckets(20000, 67) == [(0, 8192), (8192, 16384), (16384, 20000)]


def test_recompute_plan_charges_the_projection_per_bucket():
    n, da, db, kt = 512, 20000, 300, 67
    rec = plan.plan_power_project_accumulate(n, da, db, kt)
    stage, sweep = plan.plan_powerpass_staged(n, da, db, kt)
    proj = 2 * n * db * kt
    assert len(rec) == 3 and all(p.kernel == "recompute_f32" for p in rec)
    assert plan.cost(rec)[0] == stage.flops + sweep.flops + 2 * proj
    # the fused launch runs the ring's fused tile (here f32_tile's pick for P
    # too): its block and shared memory, at most its blocks per SM on every SM
    tile = plan.FUSED_F32_TILE
    assert tile == plan.f32_tile(n, kt)
    _, _, threads, per_sm = plan.F32_TILES[tile]
    assert all(p.grid[0] <= per_sm * plan.SMS and p.block == (threads,)
               and p.smem_bytes == plan.ring_smem(tile) for p in rec)
    (one,) = plan.plan_projgram(n, 9001, 970)
    assert one.flops == 2 * n * 9001 * 970 + 2 * n * 970 * 970
    assert one.bytes == 4 * (n * 9001 + 9001 * 970 + n * 970 + 970 * 970)
    # a seeded call: an omega_fill and an NN launch per Ω slab, the last fused
    seeded = plan.plan_projgram_seeded(n, 9001, 970)
    assert [p.kernel for p in seeded] == ["omega_fill_f32", "gemm_nn_f32"] * 2 + [
        "omega_fill_f32", "recompute_f32"]
    assert plan.cost(seeded)[0] == one.flops


def test_chunk_cost_counts_launches_per_schedule():
    cost = tops.chunk_cost("final", 8192, D, D, 970)
    assert {k["kernel"]: k["calls"] for k in cost["kernels"]} == {
        "recompute_f32": 2, "gemm_tn_f32": 1}
    cost = tops.chunk_cost("power", 8192, D, D, 970)
    assert {k["kernel"]: k["calls"] for k in cost["kernels"]} == {
        "gemm_nn_f32": 2, "gemm_tn_f32": 2}
    # one bucket: the same FLOPs either way, and staging adds P's round trip
    rec = tops.chunk_cost("final", 8192, D, D, 970)
    forced = tops.chunk_cost("final", 8192, D, D, 970, schedule="staged")
    assert forced["schedule"] == "staged" and forced["flops"] == rec["flops"]
    assert forced["bytes"] > rec["bytes"]
    assert tops.chunk_cost("power", 512, 256, 20000, 67)["schedule"] == "recompute/staged"
    assert tops.chunk_cost("final", 64, 8, 8, 4, engine="torch")["schedule"] is None
    with pytest.raises(ValueError, match="unknown pass kind"):
        tops.chunk_cost("middle", 8, 8, 8, 4)


def test_pick_schedule_balance_and_ties():
    from repro_torch.kernels.matmul import ROOFLINE_FLOPS_PER_BYTE, pick_schedule

    assert ROOFLINE_FLOPS_PER_BYTE == pytest.approx(20.0)
    assert pick_schedule({"staged": (100, 10), "recompute": (100, 10)}) == "recompute"
    assert pick_schedule({"staged": (2000, 10), "recompute": (4000, 10)}) == "staged"
    # memory-bound: bytes decide
    assert pick_schedule({"staged": (0, 300), "recompute": (0, 200)}) == "recompute"


# --------------------------------------------------------------------------
# fits: the engine records the schedule; p = 910 against the reference
# --------------------------------------------------------------------------


def test_engine_records_the_resolved_schedule_per_pass():
    data = PlantedCCAData(n=1024, da=96, db=80, rank=16, seed=0, chunk=256)
    A, B = (x.astype(np.float32).reshape(4, 256, -1) for x in data.materialize())
    cfg = tr.RCCAConfig(k=4, p=12, q=1, nu=0.01)
    for engine, want in [("kernels", ["recompute", "recompute"]), ("torch", [None, None])]:
        res = PassEngine(cfg, engine=engine, device="cpu").run(StackedChunks(A, B), seed=1)
        assert res.diagnostics["schedules"] == want


def test_launcher_takes_k_and_p(capsys):
    rep = cca_fit.main(["--smoke", "--device", "cpu", "--k", "6", "--p", "30", "--q", "0"])
    out = capsys.readouterr().out
    assert "k=6 p=30 q=0" in out and "schedule recompute" in out
    assert rep.result.rho.shape == (6,)
    assert rep.result.Qa.shape == (256, 36)
    assert rep.pass_schedules == ["recompute"]


N910, DA910, DB910, CHUNK910 = 2048, 1536, 1280, 512


@pytest.fixture(scope="module")
def chunks910():
    d = PlantedCCAData(n=N910, da=DA910, db=DB910, rank=120, seed=2, chunk=CHUNK910)
    A, B = (x.astype(np.float32) for x in d.materialize())
    nc = N910 // CHUNK910
    return A.reshape(nc, CHUNK910, DA910), B.reshape(nc, CHUNK910, DB910)


def test_p910_fit_matches_reference(chunks910):
    """k = 60, p = 910 (k̃ = 970) with q = 0: the final pass recomputes
    (one C bucket).  The same Ω — the seeded one, made by each package
    from seed 7 — on both sides; ρ within 1e-4.  (At q = 1 the
    reference's f32 ``orth`` returns NaN at this k̃, the fault ROADMAP
    Queue 3 records; the port's q = 1 fit is held against its own torch
    engine below.)"""
    import jax

    from repro.exec import PassEngine as JPassEngine
    from repro.exec import StackedChunks as JStacked

    Ac, Bc = chunks910
    cfg = tr.RCCAConfig(k=60, p=910, q=0, nu=0.01)
    got = PassEngine(cfg, engine="kernels", device="cpu", omega="seeded").run(
        StackedChunks(Ac, Bc), seed=7)
    assert got.diagnostics["schedules"] == ["recompute"]
    jcfg = jr.RCCAConfig(k=60, p=910, q=0, nu=0.01)
    want = JPassEngine(jcfg, engine="jnp", omega="seeded").run(
        JStacked(jnp.asarray(Ac), jnp.asarray(Bc)), jax.random.PRNGKey(7))
    assert got.rho.shape == (60,)
    assert np.max(np.abs(got.rho.numpy() - np.asarray(want.rho))) <= 1e-4


def test_p910_power_fit_stages_then_recomputes(chunks910):
    """At q = 1 the power pass — ΔY of 1536 × 1024 and 1280 × 1024
    elements, two buckets each — stages, the final pass recomputes, and
    the kernels engine's ρ is the torch engine's within 1e-6."""
    cfg = tr.RCCAConfig(k=60, p=910, q=1, nu=0.01)
    res = {e: PassEngine(cfg, engine=e, device="cpu").run(StackedChunks(*chunks910), seed=7)
           for e in ("kernels", "torch")}
    assert res["kernels"].diagnostics["schedules"] == ["staged", "recompute"]
    assert float((res["kernels"].rho - res["torch"].rho).abs().max()) <= 1e-6
    assert bool(torch.isfinite(res["kernels"].rho).all())


# --------------------------------------------------------------------------
# on the card: recompute ≡ staged bitwise (skips without CUDA)
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels are CUDA C++ with "
                    "no CPU mode (chip_smoke.py runs them on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,d,kt,da", [(333, 9001, 67, 517), (333, 9001, 1100, 20000)])
def test_cuda_recompute_is_bitwise_staged(cuda_device, n, d, kt, da):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    x = torch.randn((n, d), generator=g, device=cuda_device)
    q = torch.randn((d, kt), generator=g, device=cuda_device)
    a = torch.randn((n, da), generator=g, device=cuda_device)
    for fn, args in [(tk.projgram, (x, q)), (tk.projgram_seeded, (x, SEED_A, kt)),
                     (tk.power_project_accumulate, (a, x, q)),
                     (tk.power_project_accumulate_seeded, (a, x, SEED_B, kt))]:
        tk.reset_launch_counts()
        rec = fn(*args, schedule="recompute")
        assert tk.launch_counts() == {fn.__name__: len(plan.buckets(
            kt if fn in (tk.projgram, tk.projgram_seeded) else da, kt))}
        staged = fn(*args, schedule="staged")
        for r, s in zip(rec if isinstance(rec, tuple) else (rec,),
                        staged if isinstance(staged, tuple) else (staged,)):
            assert torch.equal(r, s)
