"""The port's Algorithm 1 against the JAX reference, at the smoke shapes.

Planted data (4096 × 256/192, k = 8, p = 24, ν = 0.01) from the
reference's numpy generator, Ω made exactly as the reference makes it
(``jax.random.split``, f32 ``normal``, one cast) and handed to the port
as numpy.  Both packages run f32; ``orth`` goes through ``eigh``, whose
LAPACK and XLA versions return bases that differ by an orthogonal
factor, so bases are compared through their projectors and X up to each
column's sign.

Tolerances: ρ abs ≤ 1e-4 (f32 rounding of two k̃ = 32 whitenings stays
near 1e-6); pass-0 ``Ya``/``Yb`` relative Frobenius ≤ 1e-5 (one f32
product per chunk, summed in the same canonical order); projectors and
X relative Frobenius ≤ 1e-3 (a subspace carries the f32 error of Y
divided by the gap of Y's singular values at k̃); feasibility ≤ 1e-4.
Measured on the CPU, the streaming cases sit at |Δρ| ≤ 7e-7, projectors
≤ 4e-5 and X ≤ 1.6e-4 apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import exact as jexact
from repro.core import rcca as jr
from repro.data.synthetic import PlantedCCAData as JPlanted
from repro.exec import PassEngine as JPassEngine
from repro.exec import StackedChunks as JStacked
from repro_torch.core import exact as texact
from repro_torch.core import rcca as tr
from repro_torch.data import PlantedCCAData
from repro_torch.exec import PassEngine, StackedChunks

N, DA, DB, K, P = 4096, 256, 192, 8, 24
CHUNK = 256  # 16 chunks: two merge groups of 8, so the pairwise tree merges


@pytest.fixture(scope="module")
def data():
    d = PlantedCCAData(n=N, da=DA, db=DB, rank=16, seed=0, chunk=CHUNK)
    A, B = d.materialize()  # float64 under numpy 2's promotion; jax takes f32
    return A.astype(np.float32), B.astype(np.float32)


def _omega(seed, kt):
    ka, kb = jax.random.split(jax.random.PRNGKey(seed))
    Qa = jax.random.normal(ka, (DA, kt), jnp.float32).astype(jnp.float32)
    Qb = jax.random.normal(kb, (DB, kt), jnp.float32).astype(jnp.float32)
    return np.array(Qa), np.array(Qb)


def _cfgs(q, center):
    kw = dict(k=K, p=P, q=q, nu=0.01, center=center)
    return jr.RCCAConfig(**kw), tr.RCCAConfig(**kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _proj(Q):
    Q = _np(Q).astype(np.float64)
    return Q @ np.linalg.solve(Q.T @ Q, Q.T)


def _sign_aligned(X, Xref):
    X, Xref = _np(X).astype(np.float64), _np(Xref).astype(np.float64)
    return X * np.sign(np.sum(X * Xref, axis=0, keepdims=True))


def _hold(port, ref, A, B, center, q):
    """The comparisons every algorithm test makes."""
    assert np.max(np.abs(_np(port.rho) - _np(ref.rho))) <= 1e-4
    assert _rel(_proj(port.Qa), _proj(ref.Qa)) <= 1e-3
    assert _rel(_proj(port.Qb), _proj(ref.Qb)) <= 1e-3
    assert _rel(_sign_aligned(port.Xa, ref.Xa), ref.Xa) <= 1e-3
    assert _rel(_sign_aligned(port.Xb, ref.Xb), ref.Xb) <= 1e-3
    lam_a, lam_b = float(port.diagnostics["lam_a"]), float(port.diagnostics["lam_b"])
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    if center:
        At, Bt = texact.center(At), texact.center(Bt)
    feas = texact.feasibility_errors(At, Bt, port.Xa, port.Xb, lam_a, lam_b)
    assert max(float(v) for v in feas.values()) <= 1e-4
    # the exact-oracle gap matches the reference's
    ex_t = texact.exact_cca(torch.from_numpy(A), torch.from_numpy(B), K, lam_a, lam_b,
                            do_center=center)
    ex_j = jexact.exact_cca(jnp.asarray(A), jnp.asarray(B), K,
                            float(ref.diagnostics["lam_a"]), float(ref.diagnostics["lam_b"]),
                            do_center=center)
    gap_t = float(ex_t.rho.sum() - port.rho.sum())
    gap_j = float(np.sum(ex_j.rho) - np.sum(ref.rho))
    assert abs(gap_t - gap_j) <= 1e-4
    assert gap_t > -1e-4  # the sketch never beats the exact optimum


@pytest.mark.parametrize("center", [False, True], ids=["raw", "centered"])
@pytest.mark.parametrize("q", [0, 1])
def test_randomized_cca_matches_reference(data, q, center):
    A, B = data
    jcfg, tcfg = _cfgs(q, center)
    Qa, Qb = _omega(3, tcfg.sketch)
    ref = jr.randomized_cca(jnp.asarray(A), jnp.asarray(B), jcfg, jax.random.PRNGKey(3))
    port = tr.randomized_cca(A, B, tcfg, Qa, Qb, device="cpu")
    _hold(port, ref, A, B, center, q)


@pytest.mark.parametrize("engine", ["kernels", "torch"])
@pytest.mark.parametrize("center", [False, True], ids=["raw", "centered"])
@pytest.mark.parametrize("q", [0, 1])
def test_streaming_matches_reference(data, q, center, engine):
    A, B = data
    nc = N // CHUNK
    Ac, Bc = A.reshape(nc, CHUNK, DA), B.reshape(nc, CHUNK, DB)
    jcfg, tcfg = _cfgs(q, center)
    Qa, Qb = _omega(5, tcfg.sketch)
    seen_j, seen_t = {}, {}

    def keep(seen):
        def cb(pass_idx, kind, acc, Qa_, Qb_):
            seen[pass_idx] = acc.result()
        return cb

    ref = JPassEngine(jcfg, engine="jnp").run(
        JStacked(jnp.asarray(Ac), jnp.asarray(Bc)), jax.random.PRNGKey(5),
        on_pass_complete=keep(seen_j))
    port = PassEngine(tcfg, engine=engine, device="cpu").run(
        StackedChunks(Ac, Bc), Qa, Qb, on_pass_complete=keep(seen_t))
    _hold(port, ref, A, B, center, q)
    s_t, s_j = seen_t[0], seen_j[0]
    fields = ("Ya", "Yb") if q else ("Ca", "Cb", "F")
    for f in fields + ("sa", "sb", "tr_a", "tr_b"):
        assert _rel(getattr(s_t, f), getattr(s_j, f)) <= 1e-5, f
    assert float(s_t.n) == float(s_j.n) == N


def test_streaming_shell_equals_engine_and_in_memory(data):
    """``randomized_cca_streaming`` is the engine run; both engines give
    the in-memory ρ on the same Ω."""
    A, B = data
    nc = N // CHUNK
    _, tcfg = _cfgs(1, False)
    Qa, Qb = _omega(7, tcfg.sketch)
    Ac, Bc = A.reshape(nc, CHUNK, DA), B.reshape(nc, CHUNK, DB)
    shell = tr.randomized_cca_streaming(Ac, Bc, tcfg, Qa, Qb, device="cpu")
    eng = PassEngine(tcfg, device="cpu").run(StackedChunks(Ac, Bc), Qa, Qb)
    assert torch.equal(shell.rho, eng.rho) and torch.equal(shell.Xa, eng.Xa)
    mem = tr.randomized_cca(A, B, tcfg, Qa, Qb, device="cpu")
    assert float((shell.rho - mem.rho).abs().max()) <= 1e-4


def test_iterator_matches_streaming(data):
    A, B = data
    nc = N // CHUNK
    _, tcfg = _cfgs(1, True)
    Qa, Qb = _omega(9, tcfg.sketch)
    src = PlantedCCAData(n=N, da=DA, db=DB, rank=16, seed=0, chunk=CHUNK)
    it = tr.randomized_cca_iterator(lambda: iter(src), DA, DB, tcfg, Qa, Qb,
                                    n_chunks=nc, device="cpu")
    st = tr.randomized_cca_streaming(A.reshape(nc, CHUNK, DA), B.reshape(nc, CHUNK, DB),
                                     tcfg, Qa, Qb, device="cpu")
    assert torch.equal(it.rho, st.rho)


def test_planted_data_copy_matches_reference():
    kw = dict(n=1000, da=37, db=29, rank=5, seed=3, chunk=300)
    mine, theirs = PlantedCCAData(**kw), JPlanted(**kw)
    assert mine.n_chunks == theirs.n_chunks == 4
    for i in range(mine.n_chunks):
        for x, y in zip(mine.get_chunk(i), theirs.get_chunk(i)):
            np.testing.assert_array_equal(x, y)


def test_draw_omega_is_f32_drawn_and_seeded():
    cfg = tr.RCCAConfig(k=2, p=3, dtype=torch.bfloat16)
    Qa, Qb = tr.draw_omega(11, 40, 30, cfg, device="cpu")
    assert Qa.shape == (40, 5) and Qb.shape == (30, 5) and Qa.dtype == torch.bfloat16
    g = torch.Generator()
    g.manual_seed(11)
    assert torch.equal(Qa, torch.randn((40, 5), generator=g).to(torch.bfloat16))
    assert torch.equal(tr.draw_omega(11, 40, 30, cfg, device="cpu")[1], Qb)


def test_engine_knob():
    assert tr.resolve_engine("kernels") == "kernels" == tr.DEFAULT_ENGINE
    assert tr.update_fn("power", "torch") is tr.update_power_stats
    assert tr.update_fn("final", "kernels") is tr.update_final_stats_kernel
    with pytest.raises(ValueError, match="unknown engine"):
        tr.resolve_engine("jnp")
    with pytest.raises(ValueError, match="unknown pass kind"):
        tr.update_fn("middle", "torch")


def test_kernel_and_plain_updates_agree():
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in [(64, 40), (64, 30)])
    Qa, Qb = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in [(40, 6), (30, 6)])
    for kind in ("power", "final"):
        init = tr.stats_init_fn(kind, 40, 30, 6, device="cpu")
        plain = tr.update_fn(kind, "torch")(init(), a, b, Qa, Qb)
        kern = tr.update_fn(kind, "kernels")(init(), a, b, Qa, Qb)
        for f in plain._fields:
            assert _rel(getattr(kern, f), getattr(plain, f)) <= 1e-6, (kind, f)


def test_exact_oracle_matches_reference(data):
    A, B = data
    A, B = A[:1024, :64], B[:1024, :48]
    for center in (False, True):
        t = texact.exact_cca(torch.from_numpy(A), torch.from_numpy(B), 5, 0.1, 0.2,
                             do_center=center)
        j = jexact.exact_cca(jnp.asarray(A), jnp.asarray(B), 5, 0.1, 0.2, do_center=center)
        assert np.max(np.abs(_np(t.rho) - np.asarray(j.rho))) <= 1e-4
        obj_t = texact.cca_objective(torch.from_numpy(A), torch.from_numpy(B), t.Xa, t.Xb)
        obj_j = jexact.cca_objective(jnp.asarray(A), jnp.asarray(B), j.Xa, j.Xb)
        if not center:
            assert abs(float(obj_t) - float(obj_j)) <= 1e-3
        feas = texact.feasibility_errors(torch.from_numpy(A), torch.from_numpy(B),
                                         t.Xa, t.Xb, 0.1, 0.2)
        if not center:
            assert max(float(v) for v in feas.values()) <= 1e-3


def test_finish_factorizes_in_f64():
    """On ill-conditioned, nearly perfectly correlated statistics (κ(C)
    ~ 1e6, ρ → 1) ``finish`` matches a float64 computation on the same
    f32 statistics to f32 rounding of ρ; an f32 factorization drifts
    ~2e-6 (on the card, above 1 — PERF.md)."""
    rng = np.random.default_rng(0)
    m, kt, k = 4000, 200, 20
    scales = np.logspace(0, -3, kt)
    Z = rng.standard_normal((m, kt)) * scales
    Pa = (Z + 1e-4 * rng.standard_normal((m, kt)) * scales).astype(np.float32)
    Pb = (Z + 1e-4 * rng.standard_normal((m, kt)) * scales).astype(np.float32)
    Ca, Cb, F = (torch.from_numpy(x) for x in (Pa.T @ Pa, Pb.T @ Pb, Pa.T @ Pb))
    eye = torch.eye(kt)
    lam = torch.tensor(1e-9)
    _, _, S, La, _ = tr.finish(Ca, Cb, F, eye, eye, eye, eye, float(m), lam, lam, k)
    assert S.dtype == torch.float32 and La.dtype == torch.float64
    C64 = [x.double().numpy() for x in (Ca, Cb, F)]
    La64 = np.linalg.cholesky(0.5 * (C64[0] + C64[0].T) + 1e-9 * np.eye(kt))
    Lb64 = np.linalg.cholesky(0.5 * (C64[1] + C64[1].T) + 1e-9 * np.eye(kt))
    Fw = np.linalg.solve(La64, C64[2]) @ np.linalg.inv(Lb64).T
    want = np.linalg.svd(Fw, compute_uv=False)[:k]
    assert np.max(np.abs(S.double().numpy() - want)) <= 3e-7
