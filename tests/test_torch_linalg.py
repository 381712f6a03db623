"""``repro_torch.core.linalg`` against ``repro.core.linalg``.

Same seeded numpy matrices through both; f32, so values agree to
relative 1e-5 where the two sides compute the same expression.  Bases
from ``eigh`` are unique only up to an orthogonal factor (LAPACK and
XLA pick differently), so ``orth``/``eigh_whiten`` are compared through
their projectors and their orthonormality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linalg as jl
from repro_torch.core import linalg as tl


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _spd(seed, d):
    X = _randn(seed, 3 * d, d)
    return X.T @ X / (3 * d) + np.eye(d, dtype=np.float32)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _proj(Q):
    Q = np.asarray(Q, np.float64)
    return Q @ np.linalg.solve(Q.T @ Q, Q.T)


def test_sym_and_chol_psd():
    M = _spd(0, 20) + 1e-3 * _randn(1, 20, 20)
    assert _rel(tl.sym(torch.from_numpy(M)), jl.sym(jnp.asarray(M))) <= 1e-7
    for jitter in (0.0, 0.5):
        got = tl.chol_psd(torch.from_numpy(M), jitter)
        assert _rel(got, jl.chol_psd(jnp.asarray(M), jitter)) <= 1e-5


@pytest.mark.parametrize("trans", [False, True])
def test_tri_solve_right(trans):
    L = np.linalg.cholesky(_spd(2, 15)).astype(np.float32)
    Y = _randn(3, 40, 15)
    got = tl.tri_solve_right(torch.from_numpy(Y), torch.from_numpy(L), trans=trans)
    assert _rel(got, jl.tri_solve_right(jnp.asarray(Y), jnp.asarray(L), trans=trans)) <= 1e-5


def test_cholesky_qr_is_a_qr_with_the_reference_factor():
    """Same R = Lᵀ as the reference; Q = Y L⁻ᵀ is orthonormal with
    Q R = Y (the reference's Q = Y L⁻¹ is neither, see ROADMAP Queue 3)."""
    Y = _randn(4, 200, 12) @ np.diag(np.logspace(0, -1, 12)).astype(np.float32)
    Qt, Rt = tl.cholesky_qr(torch.from_numpy(Y))
    _, Rj = jl.cholesky_qr(jnp.asarray(Y))
    assert _rel(Rt, Rj) <= 1e-5
    Q = Qt.double().numpy()
    assert np.abs(Q.T @ Q - np.eye(12)).max() <= 1e-5
    assert _rel(Qt @ Rt, Y) <= 1e-6


@pytest.mark.parametrize("log_cond", [0, -1, -3])
@pytest.mark.parametrize("n,d", [(300, 20), (256, 32), (64, 64)])
def test_orth_matches_reference(n, d, log_cond):
    """Same range as the reference (projectors within 1e-5), and
    orthonormal to 1e-5 at every κ.  At κ(Y) = 1e3 the reference's f32
    ``orth`` itself leaves ‖QᵀQ − I‖ at 0.1 (256 × 32) and 9.0 (64 × 64);
    the port's f64 whitening and true CholeskyQR do not."""
    Y = _randn(5, n, d) @ np.diag(np.logspace(0, log_cond, d)).astype(np.float32)
    Qt = tl.orth(torch.from_numpy(Y))
    Qj = np.asarray(jl.orth(jnp.asarray(Y)), np.float64)
    assert Qt.shape == (n, d) and Qt.dtype == torch.float32
    assert Qt.is_contiguous()  # the layout the CUDA kernels take
    Qt = Qt.double().numpy()
    assert np.abs(Qt.T @ Qt - np.eye(d)).max() <= 1e-5
    assert _rel(_proj(Qt), _proj(Qj)) <= 1e-5


def test_orth_stays_orthonormal_past_f32_whitening():
    """κ(Y) = 1e6, where an f32 Gram has lost the small directions: the
    port's Q is still orthonormal and spans Y's range."""
    Y = _randn(6, 4000, 40) @ np.diag(np.logspace(0, -6, 40)).astype(np.float32)
    Q = tl.orth(torch.from_numpy(Y)).double().numpy()
    assert np.abs(Q.T @ Q - np.eye(40)).max() <= 1e-5
    Y64 = Y.astype(np.float64)
    assert np.linalg.norm(Y64 - Q @ (Q.T @ Y64)) <= 1e-5 * np.linalg.norm(Y64)


def test_eigh_whiten_whitens():
    Y = _randn(6, 150, 10)
    G = Y.T @ Y
    Q = tl.eigh_whiten(torch.from_numpy(Y), torch.from_numpy(G)).double().numpy()
    assert np.abs(Q.T @ Q - np.eye(10)).max() <= 1e-4
    Qj = np.asarray(jl.eigh_whiten(jnp.asarray(Y), jnp.asarray(G)))
    assert _rel(_proj(Q), _proj(Qj)) <= 1e-4


def test_inv_sqrt_psd():
    M = _spd(7, 12)
    for eps in (0.0, 0.1):
        got = tl.inv_sqrt_psd(torch.from_numpy(M), eps)
        assert _rel(got, jl.inv_sqrt_psd(jnp.asarray(M), eps)) <= 1e-5


def test_topk_svd():
    F = _randn(8, 30, 30)
    Ut, St, Vt = tl.topk_svd(torch.from_numpy(F), 5)
    Uj, Sj, Vj = jl.topk_svd(jnp.asarray(F), 5)
    assert _rel(St, Sj) <= 1e-5
    for a, b in ((Ut, Uj), (Vt, Vj)):  # singular vectors up to sign
        a, b = a.numpy(), np.asarray(b)
        assert _rel(a * np.sign(np.sum(a * b, 0)), b) <= 1e-4
