"""The seeded-Ω path of the port against the reference's, and its own
bitwise contract.

Kernel level: ``proj_stage_seeded``, ``power_pass_chunk_seeded`` and
``final_pass_chunk_seeded`` (their plain versions on the CPU) against
the reference's seeded Pallas kernels in interpret mode under the staged
schedule, the same seeds on both sides and no Ω passed between them.
Tolerance f32 relative Frobenius ≤ 1e-5: the two sides sum in different
orders, and their Ω differ by at most 4 ulp (``test_torch_rand.py``).

Fit level: inside the port ``omega="seeded"`` is bitwise
``"seeded-materialized"`` for q ∈ {0, 1} with centering on and off (the
counterpart of ``tests/test_seeded_omega.py::test_fit_seeded_matches_oracle_bitwise``),
and the port's seeded fit lies within 1e-4 in ρ of the reference's under
the same integer seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rcca as jr
from repro.exec import PassEngine as JPassEngine
from repro.exec import StackedChunks as JStacked
from repro.kernels import ops as jops
from repro.kernels.powerpass import proj_stage_seeded as j_proj_stage_seeded
from repro_torch import kernels as tk
from repro_torch.core import rcca as tr
from repro_torch.data import PlantedCCAData
from repro_torch.exec import PassEngine, StackedChunks
from repro_torch.kernels import matmul, rand, ref

RTOL = 1e-5
SEED_A, SEED_B = rand.omega_seeds(11)
SEEDS = rand.omega_seeds(5)  # the fits' seed, 5, as per-view seeds


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _j(seed):
    return jnp.array(seed, jnp.uint32)


@pytest.mark.parametrize("n,d,kt", [(130, 300, 67), (77, 129, 1), (256, 1024, 256)])
def test_proj_stage_seeded_matches_reference(n, d, kt):
    x = _randn(0, n, d)
    want = j_proj_stage_seeded(jnp.asarray(x), _j(SEED_A), kt=kt, interpret=True)
    got = tk.proj_stage_seeded(torch.from_numpy(x), SEED_A, kt)
    assert got.shape == (n, kt)
    assert _rel(got, want) <= RTOL


# (n, da, db, k̃): ragged, and one with the reference's ΔYa bucketed
@pytest.mark.parametrize("n,da,db,kt", [(130, 96, 200, 67), (77, 129, 61, 33),
                                        (256, 2048, 128, 512)])
def test_power_pass_chunk_seeded_matches_reference_staged(n, da, db, kt):
    a, b = _randn(1, n, da), _randn(2, n, db)
    want = jops.power_pass_chunk_seeded(jnp.asarray(a), jnp.asarray(b), _j(SEED_A), _j(SEED_B),
                                        kt=kt, q_dtype=jnp.float32, schedule="staged",
                                        interpret=True)
    got = tk.power_pass_chunk_seeded(torch.from_numpy(a), torch.from_numpy(b), SEED_A, SEED_B,
                                     kt=kt)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= RTOL


@pytest.mark.parametrize("n,da,db,kt", [(130, 96, 200, 67), (77, 129, 61, 33),
                                        (130, 96, 200, 1100)])
def test_final_pass_chunk_seeded_matches_reference_staged(n, da, db, kt):
    a, b = _randn(3, n, da), _randn(4, n, db)
    want = jops.final_pass_chunk_seeded(jnp.asarray(a), jnp.asarray(b), _j(SEED_A), _j(SEED_B),
                                        kt=kt, q_dtype=jnp.float32, schedule="staged",
                                        interpret=True)
    got = tk.final_pass_chunk_seeded(torch.from_numpy(a), torch.from_numpy(b), SEED_A, SEED_B,
                                     kt=kt)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= RTOL


def test_seeded_chunks_equal_materialized_chunks_on_cpu():
    """On the CPU the seeded updates are the materialized ones fed
    ``dense_omega``, bit for bit, and launch nothing."""
    a, b = torch.from_numpy(_randn(5, 64, 40)), torch.from_numpy(_randn(6, 64, 30))
    Qa = rand.dense_omega(SEED_A, 40, 9, device="cpu")
    Qb = rand.dense_omega(SEED_B, 30, 9, device="cpu")
    tk.reset_launch_counts()
    pairs = [(tk.power_pass_chunk_seeded(a, b, SEED_A, SEED_B, kt=9),
              tk.power_pass_chunk(a, b, Qa, Qb)),
             (tk.final_pass_chunk_seeded(a, b, SEED_A, SEED_B, kt=9),
              tk.final_pass_chunk(a, b, Qa, Qb)),
             ((ref.proj_stage_seeded_ref(a, SEED_A, 9),), (ref.proj_stage_ref(a, Qa),))]
    for seeded, mat in pairs:
        for s, m in zip(seeded, mat):
            assert torch.equal(s, m)
    assert tk.launch_counts() == {}


# --------------------------------------------------------------------------
# fits
# --------------------------------------------------------------------------

N, DA, DB, K, P = 4096, 256, 192, 8, 24
CHUNK = 256  # 16 chunks: two merge groups of 8


@pytest.fixture(scope="module")
def chunks():
    d = PlantedCCAData(n=N, da=DA, db=DB, rank=16, seed=0, chunk=CHUNK)
    A, B = (x.astype(np.float32) for x in d.materialize())
    nc = N // CHUNK
    return A.reshape(nc, CHUNK, DA), B.reshape(nc, CHUNK, DB)


def _fit(chunks, omega, q, center, engine="kernels", seed=5):
    cfg = tr.RCCAConfig(k=K, p=P, q=q, nu=0.01, center=center)
    return PassEngine(cfg, engine=engine, device="cpu", omega=omega).run(
        StackedChunks(*chunks), seed=seed)


@pytest.mark.parametrize("engine", ["kernels", "torch"])
@pytest.mark.parametrize("center", [False, True], ids=["raw", "centered"])
@pytest.mark.parametrize("q", [0, 1])
def test_seeded_fit_is_bitwise_seeded_materialized(chunks, q, center, engine):
    got = _fit(chunks, "seeded", q, center, engine)
    want = _fit(chunks, "seeded-materialized", q, center, engine)
    for f in ("Xa", "Xb", "rho", "Qa", "Qb"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("q", [0, 1])
def test_seeded_fit_matches_reference_under_one_seed(chunks, q):
    """No Ω crosses between the packages: each makes its own from the
    integer seed."""
    Ac, Bc = chunks
    jcfg = jr.RCCAConfig(k=K, p=P, q=q, nu=0.01)
    want = JPassEngine(jcfg, engine="jnp", omega="seeded").run(
        JStacked(jnp.asarray(Ac), jnp.asarray(Bc)), jax.random.PRNGKey(5))
    got = _fit(chunks, "seeded", q, False)
    assert np.max(np.abs(got.rho.numpy() - np.asarray(want.rho))) <= 1e-4
    if q == 0:  # the returned bases are Ω itself
        assert _rel(got.Qa, want.Qa) <= 1e-6 and _rel(got.Qb, want.Qb) <= 1e-6


def test_seeded_pass_zero_takes_seeds_not_omega(chunks, monkeypatch):
    """Pass 0's update gets the two seeds in its Qa/Qb slots; no (d, k̃)
    tensor reaches it."""
    seen = []
    real = tr.seeded_update_fn

    def spy(kind, kt):
        upd = real(kind, kt)

        def wrapped(s, a, b, qa, qb):
            seen.append((tuple(a.shape), tuple(b.shape), qa, qb))
            return upd(s, a, b, qa, qb)
        return wrapped

    monkeypatch.setattr(tr, "seeded_update_fn", spy)
    _fit(chunks, "seeded", 1, False)
    assert len(seen) == N // CHUNK
    assert all(qa == SEEDS[0] and qb == SEEDS[1] for *_, qa, qb in seen)
    assert all(isinstance(w, int) for *_, qa, qb in seen for w in qa + qb)
    assert all(sa == (CHUNK, DA) and sb == (CHUNK, DB) for sa, sb, *_ in seen)


@pytest.mark.parametrize("q,center,made", [(1, False, 0), (1, True, 2), (0, False, 2)])
def test_seeded_path_makes_omega_only_where_needed(chunks, monkeypatch, q, center, made):
    """The seeded fit materializes Ω only at pass 0's boundary, for the
    centering correction or the q = 0 finalize — one ``dense_omega``
    per view — and the oracle mode up front."""
    calls = []
    real = rand.dense_omega
    monkeypatch.setattr(rand, "dense_omega", lambda *a, **k: calls.append(a) or real(*a, **k))
    _fit(chunks, "seeded", q, center)
    assert len(calls) == made
    calls.clear()
    _fit(chunks, "seeded-materialized", q, center)
    assert len(calls) == 2


def test_omega_knob_and_seed_rules():
    assert tr.OMEGA_MODES == jr.OMEGA_MODES
    with pytest.raises(ValueError, match="unknown omega"):
        tr.resolve_omega("lazy")
    cfg = tr.RCCAConfig(k=2, p=2)
    Q = np.zeros((5, 4), np.float32)
    A = np.zeros((1, 8, 5), np.float32)
    with pytest.raises(ValueError, match="explicit"):
        tr.randomized_cca_streaming(A, A, cfg, Q, Q, omega="seeded", device="cpu")
    with pytest.raises(ValueError, match="explicit"):
        tr.randomized_cca_streaming(A, A, cfg, Q, Q, seed=0, device="cpu")
    with pytest.raises(ValueError, match="or an integer seed"):
        tr.randomized_cca_streaming(A, A, cfg, device="cpu")


def test_seeded_engine_takes_bf16_and_refuses_float16_on_the_card():
    """A bf16 config runs the seeded kernels (Ω made in f32 and rounded
    once to bf16, the data's dtype); f16 and f64 have no seeded kernel,
    so on the card they raise ``TypeError``."""
    eng = PassEngine(tr.RCCAConfig(k=2, p=2, dtype=torch.bfloat16), device="cpu",
                     omega="seeded")
    assert eng.seeds_in_slots
    bf16 = torch.bfloat16
    assert matmul.cuda_form("proj_stage_seeded", bf16).label == "proj_stage_seeded[bf16]"
    for dt in (torch.float16, torch.float64):
        for entry, n in (("proj_stage_seeded", 1), ("projgram_seeded", 1),
                         ("power_project_accumulate_seeded", 2), ("omega_fill", 1)):
            with pytest.raises(TypeError, match=entry):
                matmul.cuda_form(entry, *[dt] * n)


def test_init_q_modes():
    cfg = tr.RCCAConfig(k=2, p=3)
    Qa, Qb = tr.init_Q(4, 40, 30, cfg, "seeded", device="cpu")
    sa, sb = tr.omega_seeds(4)
    assert torch.equal(Qa, rand.dense_omega(sa, 40, 5, device="cpu"))
    assert torch.equal(Qb, rand.dense_omega(sb, 30, 5, device="cpu"))
    assert torch.equal(tr.init_Q(4, 40, 30, cfg, "seeded-materialized", device="cpu")[0], Qa)
    assert torch.equal(tr.init_Q(4, 40, 30, cfg, device="cpu")[0],
                       tr.draw_omega(4, 40, 30, cfg, device="cpu")[0])


def test_streaming_shells_take_omega(chunks):
    cfg = tr.RCCAConfig(k=K, p=P, q=1, nu=0.01)
    shell = tr.randomized_cca_streaming(*chunks, cfg, seed=5, omega="seeded", device="cpu")
    assert torch.equal(shell.rho, _fit(chunks, "seeded", 1, False).rho)
    src = PlantedCCAData(n=N, da=DA, db=DB, rank=16, seed=0, chunk=CHUNK)
    it = tr.randomized_cca_iterator(lambda: (tuple(x.astype(np.float32) for x in ab)
                                             for ab in src), DA, DB, cfg, seed=5,
                                    omega="seeded", n_chunks=N // CHUNK, device="cpu")
    assert torch.equal(it.rho, shell.rho)


# --------------------------------------------------------------------------
# the seeded stage on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels are CUDA C++ with "
                    "no CPU mode (chip_smoke.py runs them on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,d,kt", [(1000, 9000, 100), (333, 517, 67)])
def test_cuda_proj_stage_seeded_is_bitwise_materialized(cuda_device, n, d, kt):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    x = torch.randn((n, d), generator=g, device=cuda_device)
    tk.reset_launch_counts()
    p = tk.proj_stage_seeded(x, SEED_A, kt)
    assert tk.launch_counts() == {"proj_stage_seeded": 1}
    assert torch.equal(p, tk.proj_stage(x, rand.omega_fill(SEED_A, d, kt, device=cuda_device)))
    want = ref.proj_stage_seeded_ref(x, SEED_A, kt)
    err = float((p - want).abs().max() / want.abs().max())
    assert err <= 4 * d ** 0.5 * 2.0 ** -24
