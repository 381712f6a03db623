"""The port's Horst baseline against the JAX reference, on the CPU.

Planted views (3000 × 48/40, rank 6, the reference's ``test_cca_core``
fixture) from the port's own numpy generator, which is the reference's
bit for bit.  Both packages get one numpy ``init_Xb`` (and, warm,
``init_Xa``): the reference's own ``jax.random`` draws or its
RandomizedCCA solution.

Tolerances: ρ abs ≤ 1e-4; ``Xa``/``Xb`` relative Frobenius ≤ 1e-3 after
each column's sign is aligned (``tests/test_torch_rcca.py``'s
conventions); the dense objective history abs ≤ 1e-4; streaming pass
counts exactly equal.  Measured here: |Δρ| ≤ 2.4e-6, X ≤ 1.1e-4,
history ≤ 4.8e-6.  The paper-claim tests are the reference's
(``tests/test_cca_core.py``) held on the port with the reference's
margins and the reference's seeds (its cold starts and its Ω, drawn by
``jax.random`` and handed over as numpy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import exact as jexact
from repro.core import horst as jh
from repro.core import rcca as jr
from repro_torch.core import exact as texact
from repro_torch.core import horst as th
from repro_torch.core import rcca as tr
from repro_torch.data import planted_views
from repro_torch.store import ingest_chunks

LAM = 1e-3
K = 5
ENGINES = ["kernels", "torch"]


@pytest.fixture(scope="module")
def views():
    A, B = planted_views(0, n=3000, da=48, db=40, rank=6, noise=0.4)
    return A.astype(np.float32), B.astype(np.float32)


@pytest.fixture(scope="module")
def exact(views):
    A, B = views
    return texact.exact_cca(torch.from_numpy(A), torch.from_numpy(B), K, LAM, LAM)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel_aligned(X, Xref):
    X, Xref = _np(X).astype(np.float64), _np(Xref).astype(np.float64)
    X = X * np.sign(np.sum(X * Xref, axis=0, keepdims=True))
    return float(np.linalg.norm(X - Xref) / np.linalg.norm(Xref))


def _hold(port, ref):
    assert np.max(np.abs(_np(port.rho) - _np(ref.rho))) <= 1e-4
    assert _rel_aligned(port.Xa, ref.Xa) <= 1e-3
    assert _rel_aligned(port.Xb, ref.Xb) <= 1e-3


def _normal(key, shape):
    return np.array(jax.random.normal(key, shape, jnp.float32))


def _chunks(A, B):
    return lambda: ((A[i::4], B[i::4]) for i in range(4))


def _ref_rcca(A, B, seed):
    """The reference's RandomizedCCA solution (k = K, p = 16, q = 1) as numpy."""
    r = jr.randomized_cca(jnp.asarray(A), jnp.asarray(B),
                          jr.RCCAConfig(k=K, p=16, q=1, lam_a=LAM, lam_b=LAM),
                          jax.random.PRNGKey(seed))
    return np.array(r.Xa), np.array(r.Xb)


def _port_rcca(A, B, seed):
    """The port's RandomizedCCA with the reference's Ω for PRNGKey(seed)."""
    ka, kb = jax.random.split(jax.random.PRNGKey(seed))
    cfg = tr.RCCAConfig(k=K, p=16, q=1, lam_a=LAM, lam_b=LAM)
    return tr.randomized_cca(A, B, cfg, _normal(ka, (A.shape[1], cfg.sketch)),
                             _normal(kb, (B.shape[1], cfg.sketch)), device="cpu")


# --------------------------------------------------------------------------
# parity with repro.core.horst
# --------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("solver", ["chol", "cg"])
def test_dense_matches_reference(views, solver, engine):
    A, B = views
    init = _normal(jax.random.PRNGKey(3), (B.shape[1], K))
    kw = dict(k=K, iters=30, lam_a=LAM, lam_b=LAM, solver=solver, cg_iters=8)
    ref = jh.horst_cca(jnp.asarray(A), jnp.asarray(B), jh.HorstConfig(**kw),
                       init_Xb=jnp.asarray(init))
    port = th.horst_cca(A, B, th.HorstConfig(**kw), init_Xb=init, engine=engine, device="cpu")
    _hold(port, ref)
    assert port.objective_history.shape == (30,)
    np.testing.assert_allclose(_np(port.objective_history), _np(ref.objective_history),
                               rtol=0, atol=1e-4)


def test_dense_nu_matches_reference(views):
    """λ from ν (scale-free, paper §4), the reference example's setting."""
    A, B = views
    init = _normal(jax.random.PRNGKey(1), (B.shape[1], K))
    kw = dict(k=K, iters=10, nu=0.01)
    ref = jh.horst_cca(jnp.asarray(A), jnp.asarray(B), jh.HorstConfig(**kw),
                       init_Xb=jnp.asarray(init))
    port = th.horst_cca(A, B, th.HorstConfig(**kw), init_Xb=init, device="cpu")
    _hold(port, ref)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("start", ["cold", "warm"])
def test_streaming_matches_reference(views, start, engine):
    A, B = views
    if start == "cold":  # the reference's own draw for PRNGKey(3)
        init = {"init_Xb": _normal(jax.random.split(jax.random.PRNGKey(3))[1],
                                   (B.shape[1], K))}
    else:
        Xa, Xb = _ref_rcca(A, B, 5)
        init = {"init_Xb": Xb, "init_Xa": Xa}
    kw = dict(k=K, iters=5, cg_iters=4)
    ref = jh.horst_cca_streaming(_chunks(A, B), A.shape[1], B.shape[1], jh.HorstConfig(**kw),
                                 lam_a=LAM, lam_b=LAM,
                                 **{k: jnp.asarray(v) for k, v in init.items()})
    port = th.horst_cca_streaming(_chunks(A, B), A.shape[1], B.shape[1], th.HorstConfig(**kw),
                                  lam_a=LAM, lam_b=LAM, engine=engine, device="cpu", **init)
    _hold(port, ref)
    passes = float(port.objective_history[0])
    assert passes == float(ref.objective_history[0])
    assert passes == sum(th.streaming_passes(5, 4, start == "warm").values())


@pytest.mark.parametrize("iters,cg_iters,warm", [(0, 3, False), (0, 3, True), (1, 2, False),
                                                 (1, 2, True), (3, 1, False), (3, 1, True)])
def test_streaming_pass_counts(views, iters, cg_iters, warm):
    """The counter equals the reference's and :func:`streaming_passes`,
    pass kind by pass kind (counted from the source's calls)."""
    A, B = views
    Xa, Xb = _ref_rcca(A, B, 5)
    init = {"init_Xb": Xb, **({"init_Xa": Xa} if warm else {})}
    calls = []

    def src():
        calls.append(1)
        return _chunks(A, B)()

    cfg = dict(k=K, iters=iters, cg_iters=cg_iters)
    ref = jh.horst_cca_streaming(_chunks(A, B), A.shape[1], B.shape[1], jh.HorstConfig(**cfg),
                                 key=jax.random.PRNGKey(0), lam_a=LAM, lam_b=LAM,
                                 **{k: jnp.asarray(v) for k, v in init.items()})
    port = th.horst_cca_streaming(src, A.shape[1], B.shape[1], th.HorstConfig(**cfg), seed=0,
                                  lam_a=LAM, lam_b=LAM, device="cpu", **init)
    want = th.streaming_passes(iters, cg_iters, warm)
    assert float(port.objective_history[0]) == float(ref.objective_history[0])
    assert len(calls) == sum(want.values()) == float(port.objective_history[0])
    assert want["cross"] == 1 + 2 * iters


@pytest.mark.parametrize("solver,iters,cg_iters", [("chol", 20, 10), ("cg", 10, 4)])
def test_card_check_settings_are_stable(solver, iters, cg_iters):
    """``chip_smoke.py`` holds the card's dense Horst to the CPU's at the
    smoke width with these settings; that comparison means something only
    where a rounding-sized change of the input moves the answer by far
    less than its tolerance (with 8 CG steps a solve the f32 CG runs past
    its rounding floor there, and X moves by several per cent)."""
    A, B = (x.astype(np.float32) for x in planted_views(0, n=4096, da=256, db=192, rank=16))
    init = torch.randn((B.shape[1], 8), generator=torch.Generator().manual_seed(0)).numpy()
    cfg = th.HorstConfig(k=8, iters=iters, nu=0.01, solver=solver, cg_iters=cg_iters)
    rng = np.random.default_rng(1)
    nudged = A * (1 + 1e-7 * rng.standard_normal(A.shape)).astype(np.float32)
    base, moved = (th.horst_cca(x, B, cfg, init_Xb=init, device="cpu") for x in (A, nudged))
    assert np.max(np.abs(_np(base.rho) - _np(moved.rho))) <= 1e-5
    assert _rel_aligned(moved.Xa, base.Xa) <= 1e-4
    assert _rel_aligned(moved.Xb, base.Xb) <= 1e-4


def test_streaming_store_bitwise(views, tmp_path):
    """Streaming Horst over a port view store ≡ the same chunks in memory."""
    A, B = views
    blocks = [(A[lo:lo + 750], B[lo:lo + 750]) for lo in range(0, A.shape[0], 750)]
    reader = ingest_chunks(str(tmp_path / "store"), iter(blocks), chunk=750)
    Xa, Xb = _ref_rcca(A, B, 7)
    cfg = th.HorstConfig(k=K, iters=2, cg_iters=2)
    got = [th.horst_cca_streaming(src, A.shape[1], B.shape[1], cfg, init_Xb=Xb, init_Xa=Xa,
                                  lam_a=LAM, lam_b=LAM, device="cpu")
           for src in (reader.iter_chunks, lambda: iter(blocks))]
    assert reader.n_chunks == len(blocks) == 4
    for x, y in zip(got[0], got[1]):
        assert torch.equal(x, y)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")


def test_default_device_raises_without_cuda(no_cuda, views):
    A, B = views
    cfg = th.HorstConfig(k=2, iters=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        th.horst_cca(A, B, cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        th.horst_cca_streaming(_chunks(A, B), A.shape[1], B.shape[1], cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        th.StreamingGrams(_chunks(A, B))


def test_cold_start_needs_a_seed(views):
    A, B = views
    with pytest.raises(ValueError, match="seed"):
        th.horst_cca(A, B, th.HorstConfig(k=2, iters=1), device="cpu")
    with pytest.raises(ValueError, match="iters"):
        th.horst_cca(A, B, th.HorstConfig(k=2, iters=0), seed=0, device="cpu")


# --------------------------------------------------------------------------
# the paper's claims (tests/test_cca_core.py), held on the port
# --------------------------------------------------------------------------


def test_horst_matches_exact(views, exact):
    A, B = views
    h = th.horst_cca(A, B, th.HorstConfig(k=K, iters=120, lam_a=LAM, lam_b=LAM),
                     init_Xb=_normal(jax.random.PRNGKey(3), (B.shape[1], K)), device="cpu")
    np.testing.assert_allclose(_np(h.rho), _np(exact.rho), atol=1e-3)
    hist = _np(h.objective_history)
    assert hist[-1] >= hist[5] - 1e-4


def test_horst_cg_solver(views, exact):
    """Approximate LS solves (paper fn.5) still converge."""
    A, B = views
    h = th.horst_cca(A, B, th.HorstConfig(k=K, iters=60, lam_a=LAM, lam_b=LAM, solver="cg",
                                          cg_iters=8),
                     init_Xb=_normal(jax.random.PRNGKey(3), (B.shape[1], K)), device="cpu")
    assert float(h.rho.sum()) > 0.98 * float(exact.rho.sum())


def test_horst_rcca_warmstart_faster(views, exact):
    """RandomizedCCA is an excellent Horst initializer (120 → 34 passes):
    with the warm start, 99.9 % of the optimum takes strictly fewer
    iterations than from a random start."""
    A, B = views
    target = 0.999 * float(exact.rho.sum())
    cfg = th.HorstConfig(k=K, iters=40, lam_a=LAM, lam_b=LAM)
    cold = th.horst_cca(A, B, cfg, init_Xb=_normal(jax.random.PRNGKey(4), (B.shape[1], K)),
                        device="cpu")
    warm = th.horst_cca(A, B, cfg, init_Xb=_port_rcca(A, B, 5).Xb, device="cpu")

    def first_hit(hist):
        idx = np.nonzero(_np(hist) >= target)[0]
        return int(idx[0]) if len(idx) else 10_000

    assert first_hit(warm.objective_history) < first_hit(cold.objective_history)


def test_streaming_horst_and_warmstart_passes(views, exact):
    """Out-of-core Horst converges, and the rcca warm start cuts the
    data-pass count ≥ 3× (Table 2b's 120 → 34, in passes)."""
    A, B = views
    da, db = A.shape[1], B.shape[1]
    cold = th.horst_cca_streaming(
        _chunks(A, B), da, db, th.HorstConfig(k=K, iters=25, cg_iters=4),
        init_Xb=_normal(jax.random.split(jax.random.PRNGKey(3))[1], (db, K)),
        lam_a=LAM, lam_b=LAM, device="cpu")
    assert float(cold.rho.sum()) > 0.985 * float(exact.rho.sum())
    r = _port_rcca(A, B, 5)
    warm = th.horst_cca_streaming(_chunks(A, B), da, db, th.HorstConfig(k=K, iters=5, cg_iters=4),
                                  init_Xb=r.Xb, init_Xa=r.Xa, lam_a=LAM, lam_b=LAM,
                                  device="cpu")
    warm_passes = float(warm.objective_history[0]) + (1 + 1)  # + rcca's q+1
    assert float(warm.rho.sum()) > 0.985 * float(exact.rho.sum())
    assert warm_passes < float(cold.objective_history[0]) / 3


def test_rcca_warmstart_cuts_horst_sweeps(views, exact):
    """Table 2b (Horst+rcca): from the RandomizedCCA output the streaming
    Horst reaches 0.997 of the optimum in at most half the sweeps a random
    start needs."""
    A, B = views
    da, db = A.shape[1], B.shape[1]

    def src():
        for lo in range(0, A.shape[0], 750):
            yield A[lo:lo + 750], B[lo:lo + 750]

    target = 0.997 * float(exact.rho.sum())
    rc = _port_rcca(A, B, 7)
    cold_init = _normal(jax.random.split(jax.random.PRNGKey(11))[1], (db, K))

    def min_sweeps(**init):
        for iters in (1, 2, 3, 4, 6, 8):
            h = th.horst_cca_streaming(src, da, db, th.HorstConfig(k=K, iters=iters, cg_iters=2),
                                       lam_a=LAM, lam_b=LAM, device="cpu", **init)
            if float(h.rho.sum()) >= target:
                return iters
        return 99

    warm = min_sweeps(init_Xb=rc.Xb, init_Xa=rc.Xa)
    cold = min_sweeps(init_Xb=cold_init)
    assert warm < cold, (warm, cold)
    assert warm <= max(1, cold // 2), (warm, cold)


def test_exact_oracle_agrees_with_reference(views, exact):
    """The optimum the claims are measured against is the reference's."""
    A, B = views
    ref = jexact.exact_cca(jnp.asarray(A), jnp.asarray(B), K, LAM, LAM)
    np.testing.assert_allclose(_np(exact.rho), _np(ref.rho), rtol=0, atol=1e-4)
