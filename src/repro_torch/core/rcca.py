"""RandomizedCCA — Algorithm 1 of Mineiro & Karampatziakis (2014).

Port of ``repro/core/rcca.py``.  Entry points sharing one ``finish``
(paper lines 19-25):

- :func:`randomized_cca` — paper-faithful in-memory version;
- :func:`randomized_cca_streaming` / :func:`randomized_cca_iterator` —
  every data pass is a fold over row chunks, shells over
  :class:`repro_torch.exec.PassEngine` (Local topology).

Ω comes one of two ways.  It is passed in (``Qa0``, ``Qb0``): jax's and
torch's generators cannot give the same numbers, so the tests hand both
packages one Ω.  Or it is made from an integer ``seed`` under one of
:data:`OMEGA_MODES`: ``"materialized"`` draws it with
:func:`draw_omega` (a seeded ``torch.Generator``); the seeded modes make
the reference's own counter-based Ω (``kernels/rand.py``), the same
numbers for the same seed in both packages, and ``"seeded"`` never
holds it on the device during pass 0.

Mean-centering is the paper's §3 rank-one update: column sums are
accumulated alongside each pass and products are corrected as
ĀᵀB̄ = AᵀB − n μa μbᵀ.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..exec.accumulate import MERGE_GROUP_CHUNKS, merge_stats
from ..kernels import ops as kops
from ..kernels import rand as krand
from ..kernels import ref as kref
from .linalg import orth, sym, topk_svd, tri_solve_right

f32 = torch.float32

#: Production default of the data-pass engine: ``"kernels"`` = the
#: hand-written CUDA kernels (their plain versions for CPU tensors);
#: ``"torch"`` = the plain PyTorch oracle path, in the role ``"jnp"``
#: plays in the reference.
DEFAULT_ENGINE = "kernels"


def resolve_engine(engine: str) -> str:
    if engine not in ("kernels", "torch"):
        raise ValueError(f"unknown engine {engine!r}; expected 'kernels' or 'torch'")
    return engine


@dataclasses.dataclass(frozen=True)
class RCCAConfig:
    """Hyper-parameters of Algorithm 1.

    k:       target embedding dimension.
    p:       oversampling (paper uses 910-2000 for k=60).
    q:       number of power-iteration data passes (0 = pure sketch).
    lam_a/b: explicit ridge regularizers; if ``nu`` is set they are
             derived scale-free as λ = ν·Tr(XᵀX)/d (paper §4).
    center:  mean-shift both views via the rank-one update.
    """

    k: int
    p: int = 100
    q: int = 1
    lam_a: float = 0.0
    lam_b: float = 0.0
    nu: Optional[float] = None
    center: bool = False
    dtype: torch.dtype = torch.float32

    @property
    def sketch(self) -> int:  # k̃ = k + p
        return self.k + self.p


def algo_meta(cfg: RCCAConfig) -> dict:
    """The hyper-parameter identity that binds persisted pass state: pass
    cursors embed and check exactly this dict.  ``dtype`` is the name
    (``"float32"``, ``"bfloat16"``), as the reference writes it."""
    return {"k": cfg.k, "p": cfg.p, "q": cfg.q, "center": cfg.center,
            "nu": cfg.nu, "lam_a": cfg.lam_a, "lam_b": cfg.lam_b,
            "dtype": str(cfg.dtype).removeprefix("torch.")}


class RCCAResult(NamedTuple):
    Xa: torch.Tensor
    Xb: torch.Tensor
    rho: torch.Tensor  # top-k canonical correlations
    Qa: torch.Tensor  # final range bases
    Qb: torch.Tensor
    diagnostics: dict


# --------------------------------------------------------------------------
# pass statistics
# --------------------------------------------------------------------------


class PowerStats(NamedTuple):
    """Accumulators of one range-finder pass (paper lines 6-9)."""

    Ya: torch.Tensor  # AᵀB Qb   (da, k̃)
    Yb: torch.Tensor  # BᵀA Qa   (db, k̃)
    sa: torch.Tensor  # Aᵀ1      (da,)
    sb: torch.Tensor  # Bᵀ1      (db,)
    n: torch.Tensor  # row count ()
    tr_a: torch.Tensor  # ‖A‖_F²  ()
    tr_b: torch.Tensor  # ‖B‖_F²  ()


class FinalStats(NamedTuple):
    """Accumulators of the final pass (paper lines 14-18)."""

    Ca: torch.Tensor  # Qaᵀ AᵀA Qa  (k̃, k̃)
    Cb: torch.Tensor  # Qbᵀ BᵀB Qb  (k̃, k̃)
    F: torch.Tensor  # Qaᵀ AᵀB Qb  (k̃, k̃)
    sa: torch.Tensor
    sb: torch.Tensor
    n: torch.Tensor
    tr_a: torch.Tensor
    tr_b: torch.Tensor


def init_power_stats(da: int, db: int, sketch: int, dtype=f32,
                     device=DEFAULT_DEVICE) -> PowerStats:
    dev = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)
    return PowerStats(Ya=z(da, sketch), Yb=z(db, sketch), sa=z(da), sb=z(db),
                      n=z(), tr_a=z(), tr_b=z())


def init_final_stats(sketch: int, da: int, db: int, dtype=f32,
                     device=DEFAULT_DEVICE) -> FinalStats:
    dev = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)
    return FinalStats(Ca=z(sketch, sketch), Cb=z(sketch, sketch), F=z(sketch, sketch),
                      sa=z(da), sb=z(db), n=z(), tr_a=z(), tr_b=z())


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """‖x‖²_F in f32 without an elementwise temporary (a chunk is 17 GB
    at Europarl width)."""
    return torch.linalg.vector_norm(x, dtype=f32) ** 2


def _row_sums(s, a: torch.Tensor, b: torch.Tensor) -> dict:
    """The plain reductions every update folds: column sums, row count
    and ‖·‖²_F."""
    return dict(
        sa=s.sa + torch.sum(a, dim=0, dtype=f32).to(s.sa.dtype),
        sb=s.sb + torch.sum(b, dim=0, dtype=f32).to(s.sb.dtype),
        n=s.n + a.shape[0],
        tr_a=s.tr_a + _sq_norm(a),
        tr_b=s.tr_b + _sq_norm(b),
    )


def update_power_stats(s: PowerStats, a, b, Qa, Qb) -> PowerStats:
    """Fold one row chunk into the range-finder accumulators (plain).

    The sum is formed in the fresh ΔY buffers (Y + ΔY and ΔY + Y are the
    same f32 bits), so no third (d, k̃) tensor is made per view.
    """
    dYa, dYb = kref.power_pass_ref(a, b, Qa, Qb)
    return PowerStats(Ya=dYa.to(s.Ya.dtype).add_(s.Ya),
                      Yb=dYb.to(s.Yb.dtype).add_(s.Yb),
                      **_row_sums(s, a, b))


def update_power_stats_kernel(s: PowerStats, a, b, Qa, Qb) -> PowerStats:
    """Kernel-backed :func:`update_power_stats`: 4 launches per chunk
    staged, 2 recomputed (``ops.power_pass_chunk``; the schedule rule
    decides per shape).

    ΔYa and ΔYb are added into ``s.Ya`` / ``s.Yb`` IN PLACE by the
    kernels (f32 accumulators, which :func:`stats_init_fn` makes).  The
    accumulator owns ``s``, so nothing else sees the update.
    """
    Ya, Yb = kops.power_pass_chunk(a, b, Qa, Qb, out=(s.Ya, s.Yb))
    return PowerStats(Ya=Ya, Yb=Yb, **_row_sums(s, a, b))


def update_final_stats(s: FinalStats, a, b, Qa, Qb) -> FinalStats:
    """Fold one row chunk into the final-pass accumulators (plain)."""
    dCa, dCb, dF = kref.final_pass_ref(a, b, Qa, Qb)
    return FinalStats(Ca=s.Ca + dCa.to(s.Ca.dtype), Cb=s.Cb + dCb.to(s.Cb.dtype),
                      F=s.F + dF.to(s.F.dtype), **_row_sums(s, a, b))


def update_final_stats_kernel(s: FinalStats, a, b, Qa, Qb) -> FinalStats:
    """Kernel-backed :func:`update_final_stats`: 5 launches per chunk
    staged, 3 recomputed (``ops.final_pass_chunk``)."""
    dCa, dCb, dF = kops.final_pass_chunk(a, b, Qa, Qb)
    return FinalStats(Ca=s.Ca + dCa.to(s.Ca.dtype), Cb=s.Cb + dCb.to(s.Cb.dtype),
                      F=s.F + dF.to(s.F.dtype), **_row_sums(s, a, b))


def merge_power_stats(x: PowerStats, y: PowerStats) -> PowerStats:
    """Combine two range-finder accumulators over disjoint row sets."""
    return merge_stats(x, y)


def merge_final_stats(x: FinalStats, y: FinalStats) -> FinalStats:
    return merge_stats(x, y)


def seeded_update_fn(kind: str, kt: int):
    """The per-chunk update of a seeded-Ω pass (kernels engine): the Qa/Qb
    slots carry the per-view seeds (two uint32 words each) instead of
    (d, k̃) tensors — the arity of :func:`update_fn`'s result, so the fold
    is unchanged — and Ω is made on the card slab by slab inside the
    seeded stage, in f32 and rounded once to the chunk's dtype (the
    config's).  Bitwise the materialized update fed
    ``rand.dense_omega(seed, d, kt, dtype)``."""
    if kind == "power":
        def upd(s: PowerStats, a, b, seed_a, seed_b) -> PowerStats:
            Ya, Yb = kops.power_pass_chunk_seeded(a, b, seed_a, seed_b, kt=kt,
                                                  out=(s.Ya, s.Yb))
            return PowerStats(Ya=Ya, Yb=Yb, **_row_sums(s, a, b))
        return upd
    if kind == "final":
        def upd(s: FinalStats, a, b, seed_a, seed_b) -> FinalStats:
            dCa, dCb, dF = kops.final_pass_chunk_seeded(a, b, seed_a, seed_b, kt=kt)
            return FinalStats(Ca=s.Ca + dCa, Cb=s.Cb + dCb, F=s.F + dF,
                              **_row_sums(s, a, b))
        return upd
    raise ValueError(f"unknown pass kind {kind!r}")


def update_fn(kind: str, engine: str):
    """The per-chunk update for one pass flavor."""
    kernels = resolve_engine(engine) == "kernels"
    if kind == "power":
        return update_power_stats_kernel if kernels else update_power_stats
    if kind == "final":
        return update_final_stats_kernel if kernels else update_final_stats
    raise ValueError(f"unknown pass kind {kind!r}")


def stats_init_fn(kind: str, da: int, db: int, sketch: int, device=DEFAULT_DEVICE):
    """Zero f32 accumulators for one pass flavor."""
    device = resolve_device(device)
    if kind == "power":
        return lambda: init_power_stats(da, db, sketch, f32, device)
    if kind == "final":
        return lambda: init_final_stats(sketch, da, db, f32, device)
    raise ValueError(f"unknown pass kind {kind!r}")


def stats_like(kind: str, da: int, db: int, sketch: int):
    """One pass flavor's accumulators as ``meta`` tensors: the shapes and
    dtypes of :func:`stats_init_fn`'s, holding no memory."""
    def z(*shape):
        return torch.empty(shape, dtype=f32, device="meta")
    if kind == "power":
        return PowerStats(Ya=z(da, sketch), Yb=z(db, sketch), sa=z(da), sb=z(db),
                          n=z(), tr_a=z(), tr_b=z())
    if kind == "final":
        return FinalStats(Ca=z(sketch, sketch), Cb=z(sketch, sketch), F=z(sketch, sketch),
                          sa=z(da), sb=z(db), n=z(), tr_a=z(), tr_b=z())
    raise ValueError(f"unknown pass kind {kind!r}")


# --------------------------------------------------------------------------
# centering corrections (rank-one updates, paper §3)
# --------------------------------------------------------------------------


# The f32 means meet Q promoted to f32, as jnp promotes a bf16 Q (torch
# refuses the mixed product); for an f32 Q the promotion is the identity.


def centered_Y(s: PowerStats, Qa, Qb, center: bool):
    if not center:
        return s.Ya, s.Yb
    n = torch.clamp(s.n, min=1.0)
    mu_a, mu_b = s.sa / n, s.sb / n
    Ya = s.Ya - n * torch.outer(mu_a, mu_b @ Qb.to(f32))  # ĀᵀB̄Qb = AᵀBQb − n μa(μbᵀQb)
    Yb = s.Yb - n * torch.outer(mu_b, mu_a @ Qa.to(f32))
    return Ya, Yb


def centered_CF(s: FinalStats, Qa, Qb, center: bool):
    if not center:
        return s.Ca, s.Cb, s.F
    n = torch.clamp(s.n, min=1.0)
    qa = Qa.T.to(f32) @ (s.sa / n)  # (k̃,) = Qaᵀ μa
    qb = Qb.T.to(f32) @ (s.sb / n)
    return (s.Ca - n * torch.outer(qa, qa), s.Cb - n * torch.outer(qb, qb),
            s.F - n * torch.outer(qa, qb))


def resolve_lambdas(cfg: RCCAConfig, tr_a, tr_b, da: int, db: int):
    if cfg.nu is None:
        dev = torch.as_tensor(tr_a).device
        return (torch.tensor(cfg.lam_a, dtype=f32, device=dev),
                torch.tensor(cfg.lam_b, dtype=f32, device=dev))
    return cfg.nu * tr_a / da, cfg.nu * tr_b / db


# --------------------------------------------------------------------------
# Ω and the per-pass transitions
# --------------------------------------------------------------------------


def draw_omega(seed: int, da: int, db: int, cfg: RCCAConfig, *,
               device=DEFAULT_DEVICE) -> tuple[torch.Tensor, torch.Tensor]:
    """Lines 1-2: Gaussian sketch bases drawn on ``device`` from a
    ``torch.Generator`` seeded by ``seed``.  Drawn in f32 with one cast
    to ``cfg.dtype``, as the reference does."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    Qa = torch.randn((da, cfg.sketch), generator=g, dtype=f32, device=dev)
    Qb = torch.randn((db, cfg.sketch), generator=g, dtype=f32, device=dev)
    return Qa.to(cfg.dtype), Qb.to(cfg.dtype)


#: Ω's provenance, as ``repro/core/rcca.py`` ``OMEGA_MODES``:
#: - ``"materialized"`` — :func:`draw_omega`, the array threaded everywhere;
#: - ``"seeded"`` — Ω a pure function of per-view seeds
#:   (:mod:`repro_torch.kernels.rand`); under the kernels engine pass 0
#:   makes it slab by slab inside the seeded stage and never holds the
#:   (d, k̃) array;
#: - ``"seeded-materialized"`` — the same Ω made up front and run through
#:   the materialized update: the bitwise oracle of ``"seeded"``.
OMEGA_MODES = ("materialized", "seeded", "seeded-materialized")


def resolve_omega(omega: str) -> str:
    if omega not in OMEGA_MODES:
        raise ValueError(f"unknown omega {omega!r}; expected one of {OMEGA_MODES}")
    return omega


def omega_seeds(seed: int):
    """Per-view Ω seeds of an integer seed, view a first: the bits the
    reference derives from ``jax.random.PRNGKey(seed)``."""
    return krand.omega_seeds(seed)


def init_Q(seed: int, da: int, db: int, cfg: RCCAConfig, omega: str = "materialized", *,
           device=DEFAULT_DEVICE):
    """Lines 1-2: the sketch bases for an integer seed, made in f32 and
    cast once to ``cfg.dtype``.  The seeded modes materialize the
    counter-based Ω (``omega_fill`` on the card)."""
    if resolve_omega(omega) == "materialized":
        return draw_omega(seed, da, db, cfg, device=device)
    seed_a, seed_b = omega_seeds(seed)
    return (krand.dense_omega(seed_a, da, cfg.sketch, cfg.dtype, device=device),
            krand.dense_omega(seed_b, db, cfg.sketch, cfg.dtype, device=device))


def power_update_Q(stats: PowerStats, Qa, Qb, cfg: RCCAConfig):
    """Lines 10-11: close one range-finder pass (center + orth)."""
    Ya, Yb = centered_Y(stats, Qa, Qb, cfg.center)
    return orth(Ya.to(cfg.dtype)), orth(Yb.to(cfg.dtype))


def finalize_result(fstats: FinalStats, Qa, Qb, cfg: RCCAConfig,
                    da: int, db: int) -> RCCAResult:
    """Lines 19-25 from merged final-pass statistics."""
    Ca, Cb, F = centered_CF(fstats, Qa, Qb, cfg.center)
    lam_a, lam_b = resolve_lambdas(cfg, fstats.tr_a, fstats.tr_b, da, db)
    QtQa = sym((Qa.T @ Qa).to(f32))
    QtQb = sym((Qb.T @ Qb).to(f32))
    Xa, Xb, S, _, _ = finish(Ca, Cb, F, QtQa, QtQb, Qa.to(f32), Qb.to(f32),
                             fstats.n, lam_a, lam_b, cfg.k)
    return RCCAResult(Xa=Xa, Xb=Xb, rho=S, Qa=Qa, Qb=Qb,
                      diagnostics={"lam_a": lam_a, "lam_b": lam_b, "n": fstats.n})


def finish(Ca, Cb, F, QtQa, QtQb, Qa, Qb, n, lam_a, lam_b, k: int):
    """Lines 19-25: whiten F in the Q bases, SVD, map back to X.

    Lower-Cholesky convention (L Lᵀ = C), as the reference: F ← La⁻¹ F
    Lb⁻ᵀ and Xa = √n Qa La⁻ᵀ U, the equivalent of the paper's Matlab
    (upper R) F ← La⁻ᵀ F Lb⁻¹ and Xa = √n Qa La⁻¹ U.

    The k̃ × k̃ factorizations run in float64 (the reference: f32).  At
    Europarl width κ(Ca + λa QaᵀQa) is ~1e5, and on the card the f32
    Cholesky, solves and SVD of the same statistics put the top ρ above
    1; in f64 they cost a few k̃³ and return ρ ≤ 1.  X and ρ come back in
    Q's dtype.
    """
    f64 = torch.float64
    La = torch.linalg.cholesky(sym(Ca.to(f64) + lam_a * QtQa.to(f64)))
    Lb = torch.linalg.cholesky(sym(Cb.to(f64) + lam_b * QtQb.to(f64)))
    Fw = torch.linalg.solve_triangular(La, F.to(f64), upper=False)  # La⁻¹ F
    Fw = tri_solve_right(Fw, Lb, trans=True)  # ... Lb⁻ᵀ
    U, S, V = topk_svd(Fw, k)
    dt = Qa.dtype
    sqn = torch.sqrt(torch.as_tensor(n, dtype=dt, device=Qa.device))
    Xa = sqn * (Qa @ torch.linalg.solve_triangular(La.T, U, upper=True).to(dt))
    Xb = sqn * (Qb @ torch.linalg.solve_triangular(Lb.T, V, upper=True).to(dt))
    return Xa, Xb, S.to(dt), La, Lb


# --------------------------------------------------------------------------
# in-memory, paper-faithful
# --------------------------------------------------------------------------


def _as(x, dev, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, device=dev, dtype=dtype)


def randomized_cca(A, B, cfg: RCCAConfig, Qa0, Qb0, *,
                   device=DEFAULT_DEVICE) -> RCCAResult:
    """Algorithm 1, verbatim, for in-memory A, B with Ω = (Qa0, Qb0).
    Rows are taken in ``cfg.dtype``."""
    dev = resolve_device(device)
    A, B = _as(A, dev, cfg.dtype), _as(B, dev, cfg.dtype)
    n, da = A.shape
    db = B.shape[1]
    Qa, Qb = _as(Qa0, dev, cfg.dtype), _as(Qb0, dev, cfg.dtype)

    if cfg.center:
        A = A - A.mean(dim=0, keepdim=True)
        B = B - B.mean(dim=0, keepdim=True)

    for _ in range(cfg.q):  # lines 5-12
        Ya = A.T @ (B @ Qb)
        Yb = B.T @ (A @ Qa)
        Qa, Qb = orth(Ya), orth(Yb)

    Pa, Pb = A @ Qa, B @ Qb  # lines 14-18 (final pass)
    Ca, Cb, F = sym(Pa.T @ Pa), sym(Pb.T @ Pb), Pa.T @ Pb
    lam_a, lam_b = resolve_lambdas(cfg, _sq_norm(A), _sq_norm(B), da, db)
    Xa, Xb, S, _, _ = finish(Ca, Cb, F, sym(Qa.T @ Qa), sym(Qb.T @ Qb), Qa, Qb,
                             float(n), lam_a, lam_b, cfg.k)
    return RCCAResult(Xa=Xa, Xb=Xb, rho=S, Qa=Qa, Qb=Qb,
                      diagnostics={"lam_a": lam_a, "lam_b": lam_b, "n": n})


# --------------------------------------------------------------------------
# streaming — shells over the repro_torch.exec pass engine
# --------------------------------------------------------------------------


def randomized_cca_streaming(A_chunks, B_chunks, cfg: RCCAConfig, Qa0=None, Qb0=None, *,
                             seed: Optional[int] = None, omega: str = "materialized",
                             engine: str = DEFAULT_ENGINE,
                             merge_group: int = MERGE_GROUP_CHUNKS,
                             device=DEFAULT_DEVICE) -> RCCAResult:
    """Algorithm 1 where every data pass folds the row chunks of
    ``A_chunks`` (nc, c, da) / ``B_chunks`` (nc, c, db), from Ω =
    (Qa0, Qb0) or from ``seed`` under ``omega``."""
    from ..exec.engine import PassEngine, StackedChunks

    eng = PassEngine(cfg, engine=engine, merge_group=merge_group, device=device, omega=omega)
    return eng.run(StackedChunks(A_chunks, B_chunks), Qa0, Qb0, seed=seed)


def randomized_cca_iterator(source_factory, da: int, db: int, cfg: RCCAConfig,
                            Qa0=None, Qb0=None, *, seed: Optional[int] = None,
                            omega: str = "materialized", engine: str = DEFAULT_ENGINE,
                            merge_group: int = MERGE_GROUP_CHUNKS,
                            n_chunks: Optional[int] = None,
                            resume_state: Optional[dict] = None, on_pass_end=None,
                            on_pass_complete=None,
                            device=DEFAULT_DEVICE) -> RCCAResult:
    """Out-of-core entry point: ``source_factory`` yields (a, b) row chunks,
    once per pass (from a chunk index when its first parameter is named
    ``start``).  A shell over :meth:`PassEngine.run_stream`."""
    from ..exec.engine import PassEngine

    eng = PassEngine(cfg, engine=engine, merge_group=merge_group, device=device, omega=omega)
    return eng.run_stream(source_factory, da, db, Qa0, Qb0, seed=seed, n_chunks=n_chunks,
                          resume_state=resume_state, on_pass_end=on_pass_end,
                          on_pass_complete=on_pass_complete)

