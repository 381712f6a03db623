"""Horst iteration for CCA — the paper's baseline (§2, Table 2b).

Port of ``repro/core/horst.py``.  Gauss-Seidel variant of the
Horst/orthogonal power method for the multivariate eigenvalue problem
(Chu & Watterson 1993; Zhang & Chu 2011): alternate regularized
least-squares solves with block normalization in the covariance metric.
One Horst iteration costs two data passes (one per view); the paper's
budget is 120 passes.  ``Horst+rcca`` — initializing from a
RandomizedCCA solution — cuts that to ~34 in the paper.

- :func:`horst_cca` — dense: the d × d Grams are formed once (under
  ``engine="kernels"`` by ``matmul_tn``, the port of ``_mm_tn_kernel``),
  then the iteration runs on them;
- :func:`horst_cca_streaming` — every product with the data is a pass
  over the row chunks (:class:`StreamingGrams`), O(d·k) state only.

Precision: rows, Grams and every d × k update are f32, as in the
reference; the k × k algebra (the metric Grams WᵀMW, their inverse square
roots, the objective and the final SVD) runs in float64, as the port's
``orth`` and ``finish`` do.  Randomness: a cold start draws its Gaussian
from a ``torch.Generator`` seeded with ``seed`` (the reference takes a
jax key); the tests hand both packages one ``init_Xb``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels import ops as kops
from ..kernels.matmul import matmul_tn
from .linalg import inv_sqrt_psd, sym
from .rcca import DEFAULT_ENGINE, resolve_engine

f32, f64 = torch.float32, torch.float64


@dataclasses.dataclass(frozen=True)
class HorstConfig:
    k: int
    iters: int = 60  # each iteration = 2 data passes
    lam_a: float = 0.0
    lam_b: float = 0.0
    nu: Optional[float] = None
    solver: str = "chol"  # "chol" (exact, d³) | "cg" (approximate LS, paper fn.5)
    cg_iters: int = 10


class HorstResult(NamedTuple):
    Xa: torch.Tensor
    Xb: torch.Tensor
    rho: torch.Tensor
    # dense: (iters,) train objective per iteration; streaming: [passes]
    objective_history: torch.Tensor


def _as(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, device=dev, dtype=f32).contiguous()


def _gram64(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """XᵀY in float64, symmetrized (a metric Gram of two d × k blocks)."""
    return sym(X.to(f64).T @ Y.to(f64))


def _normalizer(G: torch.Tensor) -> torch.Tensor:
    """(G)^{-1/2} of a k × k float64 metric Gram, as an f32 right factor."""
    return inv_sqrt_psd(G, eps=1e-12).to(f32)


def _metric_normalize(W: torch.Tensor, M_mul, n: int) -> torch.Tensor:
    """X ← √n · W (Wᵀ M W)^{-1/2} so that Xᵀ M X = n I."""
    return math.sqrt(n) * (W @ _normalizer(_gram64(W, M_mul(W))))


def _cg_solve(M_mul, RHS: torch.Tensor, iters: int) -> torch.Tensor:
    """Block conjugate gradient for M X = RHS, one independent CG per
    column, from X = 0 (approximate LS, paper's footnote 5: solves need
    only be approximate for convergence)."""
    X, R, P = torch.zeros_like(RHS), RHS, RHS
    rs = torch.sum(R * R, 0)
    for _ in range(iters):
        MP = M_mul(P)
        alpha = rs / torch.clamp(torch.sum(P * MP, 0), min=1e-30)
        X = X + P * alpha
        R = R - MP * alpha
        rs_new = torch.sum(R * R, 0)
        P = R + P * (rs_new / torch.clamp(rs, min=1e-30))
        rs = rs_new
    return X


def _gaussian(seed: Optional[int], shape, dev) -> torch.Tensor:
    """The cold start's Gaussian block (paper fn.5), from ``seed``."""
    if seed is None:
        raise ValueError("a cold start (no init_Xb) needs a seed")
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    return torch.randn(shape, generator=g, dtype=f32, device=dev)


def _rotate(Xa, Xb, F64) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Xa, Xb, ρ) in canonical coordinates: the SVD of the k × k
    cross-covariance F64 = XaᵀAᵀB·Xb / n (float64) diagonalizes it; ρ are
    its singular values."""
    U, S, Vh = torch.linalg.svd(F64)
    return Xa @ U.to(f32), Xb @ Vh.T.to(f32), S.to(f32)


def horst_cca(A, B, cfg: HorstConfig, *, seed: Optional[int] = None, init_Xb=None,
              engine: str = DEFAULT_ENGINE, device=DEFAULT_DEVICE) -> HorstResult:
    """Dense Horst iteration.  ``init_Xb`` warm-starts (Horst+rcca); else
    the start is a Gaussian drawn from ``seed``.  Rows are taken in f32 on
    ``device``.

    The Grams AᵀA, BᵀB and AᵀB are formed once (``matmul_tn`` under the
    kernels engine, ``torch.matmul`` under the torch engine); each
    iteration then solves against them, by a Cholesky factor or by
    ``cfg.cg_iters`` CG steps, and normalizes in the regularized metric.
    """
    dev = resolve_device(device)
    kernels = resolve_engine(engine) == "kernels"
    if cfg.iters < 1:
        raise ValueError(f"horst_cca needs iters >= 1, got {cfg.iters}")
    if cfg.solver not in ("chol", "cg"):
        raise ValueError(f"unknown solver {cfg.solver!r}; expected 'chol' or 'cg'")
    A, B = _as(A, dev), _as(B, dev)
    n, da = A.shape
    db = B.shape[1]
    if cfg.nu is not None:
        lam_a = cfg.nu * float(torch.sum(A * A)) / da
        lam_b = cfg.nu * float(torch.sum(B * B)) / db
    else:
        lam_a, lam_b = cfg.lam_a, cfg.lam_b

    tn = matmul_tn if kernels else (lambda x, y: x.T @ y)
    Caa, Cbb, Cab = sym(tn(A, A)), sym(tn(B, B)), tn(A, B)

    def Ma(X):
        return Caa @ X + lam_a * X

    def Mb(X):
        return Cbb @ X + lam_b * X

    if cfg.solver == "chol":
        La = torch.linalg.cholesky(Caa + lam_a * torch.eye(da, dtype=f32, device=dev))
        Lb = torch.linalg.cholesky(Cbb + lam_b * torch.eye(db, dtype=f32, device=dev))

        def solve_a(R):
            return torch.cholesky_solve(R, La)

        def solve_b(R):
            return torch.cholesky_solve(R, Lb)
    else:
        def solve_a(R):
            return _cg_solve(Ma, R, cfg.cg_iters)

        def solve_b(R):
            return _cg_solve(Mb, R, cfg.cg_iters)

    Xb = _gaussian(seed, (db, cfg.k), dev) if init_Xb is None else _as(init_Xb, dev)
    Xb = _metric_normalize(Xb, Mb, n)
    objs = []
    for _ in range(cfg.iters):
        Xa = _metric_normalize(solve_a(Cab @ Xb), Ma, n)  # LS: argmin ‖A Xa − B Xb‖² + λ‖Xa‖²
        Xb = _metric_normalize(solve_b(Cab.T @ Xa), Mb, n)  # Gauss-Seidel: the fresh Xa
        CXb = Cab @ Xb
        objs.append(torch.trace(Xa.to(f64).T @ CXb.to(f64)) / n)
    Xa, Xb, rho = _rotate(Xa, Xb, Xa.to(f64).T @ CXb.to(f64) / n)
    return HorstResult(Xa=Xa, Xb=Xb, rho=rho, objective_history=torch.stack(objs).to(f32))


# ---------------------------------------------------------------------------
# streaming / out-of-core Horst (the paper's actual large-scale regime)
# ---------------------------------------------------------------------------


def streaming_passes(iters: int, cg_iters: int, warm_a: bool) -> dict:
    """Data passes of :func:`horst_cca_streaming` by kind: ``"cross"``
    (the bootstrap and the two combined normalize+cross passes an
    iteration), ``"gram_a"`` / ``"gram_b"`` (the CG matvecs: ``cg_iters``
    per view and iteration, plus one warm-start residual pass, which the A
    side takes from the first iteration when ``init_Xa`` is given and both
    sides take from the second on).  Their sum is
    ``objective_history[0]``."""
    later = max(iters - 1, 0)
    return {"cross": 1 + 2 * iters,
            "gram_a": iters * cg_iters + later + int(warm_a and iters > 0),
            "gram_b": iters * cg_iters + later}


class StreamingGrams:
    """Gram-vector products as streamed data passes, with an explicit
    pass counter — the currency of the paper's Table 2b.  Never
    materializes AᵀA (O(d·k) state only).

    Each chunk's product is summed in order into an f32 accumulator on
    the device (``G + u``, as the reference).  Under ``engine="kernels"``
    a chunk of a Gram pass is ``power_project_accumulate(x, x, V,
    out=G)`` (its schedule by the rule: one fused launch per ΔY bucket,
    or ``proj_stage`` + ``powerpass_sweep``), and a chunk of a combined
    pass is one ``proj_stage`` and two ``powerpass_sweep`` into the two
    accumulators; under ``engine="torch"`` the same products are
    ``torch.matmul``.  Rows are taken in f32 on ``device``.
    """

    def __init__(self, source_factory, *, engine: str = DEFAULT_ENGINE,
                 device=DEFAULT_DEVICE):
        self.source_factory = source_factory
        self.kernels = resolve_engine(engine) == "kernels"
        self.device = resolve_device(device)
        self.passes = 0
        self.n = None

    def _fold(self, step, state):
        """One data pass: ``state = step(a, b, state)`` over the chunks in
        order → (state, rows).  No chunk is held while the source makes
        the next one (at Europarl width a chunk pair is 34 GB)."""
        self.passes += 1
        it = iter(self.source_factory())
        rows = 0
        while (ab := next(it, None)) is not None:
            a, b = _as(ab[0], self.device), _as(ab[1], self.device)
            del ab
            state = step(a, b, state)
            rows += a.shape[0]
            del a, b
        return state, rows

    def _gram(self, x, V, G):
        if self.kernels:
            return kops.power_project_accumulate(x, x, V, out=G)
        u = x.T @ (x @ V)
        return u if G is None else G + u

    def _norm_cross(self, x, y, W, acc):
        U, V = acc
        if self.kernels:
            p = kops.stage_project(x, W)
            return kops.sweep_accumulate(x, p, out=U), kops.sweep_accumulate(y, p, out=V)
        p = x @ W
        u, v = x.T @ p, y.T @ p
        return (u, v) if U is None else (U + u, V + v)

    def gram_a(self, V):
        """One pass → AᵀA·V (the view-A CG matvec)."""
        return self._fold(lambda a, b, G: self._gram(a, V, G), None)[0]

    def gram_b(self, V):
        """One pass → BᵀB·V."""
        return self._fold(lambda a, b, G: self._gram(b, V, G), None)[0]

    def norm_cross_a(self, Wa):
        """One pass → (AᵀA·Wa, BᵀA·Wa): everything the A-side metric
        normalization AND the follow-up B-side cross product need —
        both are linear in Wa, so one pass serves both."""
        UV, self.n = self._fold(lambda a, b, acc: self._norm_cross(a, b, Wa, acc),
                                (None, None))
        return UV

    def norm_cross_b(self, Wb):
        """One pass → (BᵀB·Wb, AᵀB·Wb)."""
        UV, self.n = self._fold(lambda a, b, acc: self._norm_cross(b, a, Wb, acc),
                                (None, None))
        return UV


def horst_cca_streaming(source_factory, da: int, db: int, cfg: HorstConfig, *,
                        seed: Optional[int] = None, init_Xb=None, init_Xa=None,
                        lam_a: float = 0.0, lam_b: float = 0.0,
                        engine: str = DEFAULT_ENGINE,
                        device=DEFAULT_DEVICE) -> HorstResult:
    """Horst iteration with every matrix product a streamed data pass
    (paper §2: the multiplication step runs directly in the X coordinate
    system; AᵀA is never materialized).  ``source_factory()`` yields the
    (a, b) row chunks once per pass.  The regularized LS solves use a few
    CG iterations whose matvecs are data passes — the paper's footnote-5
    regime (approximate solves still converge).

    The update order is Gauss-Seidel, matching :func:`horst_cca`: the
    B-side solve uses the FRESH Xa.  (A simultaneous/Jacobi update of
    both views is not monotone for the Horst iteration and stalls in a
    limit cycle well below the optimum.)  Passes are shared where the
    dependency structure allows: each view's metric normalization and
    the other view's next cross product are both linear in the solved W,
    so one combined pass (norm_cross_*) serves both.  CG solves warm-
    start from the previous iteration's W (the A side from ``init_Xa``
    when given).

    Pass cost per Horst iteration: 2·(cg_iters + warm-start residual)
    CG matvecs + 2 combined normalize+cross passes, plus one bootstrap
    pass (:func:`streaming_passes` by kind).  The total is in
    ``objective_history[0]`` via the StreamingGrams counter; use
    ``init_Xb`` (and ``init_Xa``) from RandomizedCCA for the Horst+rcca
    warm start and compare pass counts with Alg. 1's q+1 (Table 2b).
    A cold start draws Xb from ``seed``.
    """
    dev = resolve_device(device)
    k = cfg.k
    Xb = _gaussian(seed, (db, k), dev) if init_Xb is None else _as(init_Xb, dev)
    grams = StreamingGrams(source_factory, engine=engine, device=dev)

    def cg_view(gram_fn, lam, R, W0):
        """CG on (G + λ)W = R; W0=None starts from zero (saves the
        warm-start residual pass)."""
        if W0 is None:
            W, r = torch.zeros_like(R), R
        else:
            W = W0
            r = R - (gram_fn(W0) + lam * W0)
        p, rs = r, torch.sum(r * r, 0)
        for _ in range(cfg.cg_iters):
            Gp = gram_fn(p) + lam * p
            alpha = rs / torch.clamp(torch.sum(p * Gp, 0), min=1e-30)
            W = W + p * alpha
            r = r - Gp * alpha
            rs2 = torch.sum(r * r, 0)
            p = r + p * (rs2 / torch.clamp(rs, min=1e-30))
            rs = rs2
        return W

    # bootstrap: normalize the initial Xb in the B metric and produce the
    # first A-side RHS Ra = AᵀB·Xb — one combined pass
    Ub, Va = grams.norm_cross_b(Xb)
    n = grams.n
    sqn = math.sqrt(n)
    Tb = _normalizer(_gram64(Xb, Ub) + lam_b * _gram64(Xb, Xb))
    Xb, Ra = sqn * (Xb @ Tb), sqn * (Va @ Tb)

    Wa = _as(init_Xa, dev) if init_Xa is not None else None
    Wb = None
    # iters=0 (warm-start evaluation only): the loop never assigns Xa
    Xa = Wa if Wa is not None else _gaussian(0 if seed is None else seed, (da, k), dev)
    for _ in range(cfg.iters):
        # view A: LS solve, then one pass for (normalization, B-side RHS)
        Wa = cg_view(grams.gram_a, lam_a, Ra, Wa)
        Ua, Vb = grams.norm_cross_a(Wa)
        Ta = _normalizer(_gram64(Wa, Ua) + lam_a * _gram64(Wa, Wa))
        Xa, Rb = sqn * (Wa @ Ta), sqn * (Vb @ Ta)  # Rb = BᵀA·Xa — Gauss-Seidel: fresh Xa
        # view B likewise; its combined pass yields the next Ra
        Wb = cg_view(grams.gram_b, lam_b, Rb, Wb)
        Ub, Va = grams.norm_cross_b(Wb)
        Tb = _normalizer(_gram64(Wb, Ub) + lam_b * _gram64(Wb, Wb))
        Xb, Ra = sqn * (Wb @ Tb), sqn * (Va @ Tb)

    # canonical rotation + objective: Ra is already AᵀB·Xb for the final Xb
    Xa, Xb, rho = _rotate(Xa, Xb, Xa.to(f64).T @ Ra.to(f64) / n)
    return HorstResult(Xa=Xa, Xb=Xb, rho=rho,
                       objective_history=torch.tensor([grams.passes], dtype=f32, device=dev))
