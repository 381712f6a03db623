"""The power-pass products: ΔY = Aᵀ(B·Q), staged or recomputed.

Port of ``repro/kernels/powerpass.py``.  Two schedules, bitwise equal:

- *staged*: :func:`proj_stage` (P = X·Q in f32, the port of
  ``_proj_stage_kernel``) writes P to device memory, then
  :func:`powerpass_sweep` (ΔY = Aᵀ·P, ``_powerpass_sweep_kernel``)
  reads it back: 2 launches;
- *recompute*: one fused launch per ΔY bucket (``csrc/recompute_f32.cu``,
  the port of ``_powerpass_kernel``) projects P and folds it into ΔY with
  P held in L2 between its phases; a shape of several buckets projects P
  again for each (:data:`~repro_torch.kernels.plan.ONE_BUCKET_ELEMS`).

:func:`power_project_accumulate` picks one per shape
(:func:`choose_powerpass_schedule`) unless told.  The seeded forms make
Ω(seed) on the card in K-slabs of 4096 rows, each contracted as it is
made, so no (d, k̃) Ω exists: :func:`proj_stage_seeded` (the port of
``_proj_stage_seeded_kernel``) and the recompute of
:func:`power_project_accumulate_seeded` (``_powerpass_seeded_kernel``).

Each phase is one CUDA launch over an (output tiles) grid that contracts
its whole K range inside a block, and P is the exact (n, k̃) f32 tensor:
nothing is padded.

Operands are f32 or bf16 (``matmul.FORMS``): bf16 X and Q give an f32 P
(tensor cores), the sweep takes bf16 A with a bf16 P (tensor cores) or
an f32 P (A widened, CUDA cores), and the recompute takes bf16 A, B and
Q.  The seeded forms make Ω in the data's dtype: in bf16 each Ω slab is
made in f32 and rounded once, as the reference's ``.astype(q_dtype)``
with ``q_dtype`` the config's dtype.  The bf16 launches count under e.g.
``proj_stage[bf16]`` or ``proj_stage_seeded[bf16]``.
"""

from __future__ import annotations

import functools

import torch

from . import plan, ref
from .matmul import (_check_out, _grid_ok, form, gemm_nn, gemm_nn_seeded, gemm_tn, on_cpu,
                     pick_schedule, recompute)


def proj_stage(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P = x·q in f32.  x: (n, d), q: (d, k̃) → (n, k̃), both f32 or both
    bf16."""
    if on_cpu(x, q):
        return ref.proj_stage_ref(x, q)
    return gemm_nn(form("proj_stage", x, q), x, q)


def powerpass_sweep(a: torch.Tensor, p: torch.Tensor, *,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """ΔY = aᵀ·p in f32.  a: (n, da), p: (n, k̃) → (da, k̃); a and p f32,
    a and p bf16, or a bf16 and p f32.

    With ``out`` (a (da, k̃) f32 accumulator) the kernel adds ΔY into
    ``out`` in place, after the full contraction — the same rounding as
    ``out + ΔY`` — and returns ``out``.  At Europarl width that saves a
    4.3 GB ΔY temporary per view and chunk.
    """
    if on_cpu(a, p, *(() if out is None else (out,))):
        dY = ref.powerpass_sweep_ref(a, p)
        return dY if out is None else out.add_(dY)
    return gemm_tn(form("powerpass_sweep", a, p), a, p, out)


def proj_stage_seeded(x: torch.Tensor, seed, kt: int) -> torch.Tensor:
    """P = x·Ω(seed) in f32, Ω in x's dtype.  x: (n, d), seed: the view's
    two uint32 words → (n, k̃).  On the card, bitwise ``proj_stage(x,
    omega_fill(seed, d, kt, dtype=x.dtype))``: the slabs continue each
    element's chain, so its order is the materialized product's.  One
    entry-point launch issues 2·⌈d / ``plan.SEEDED_SLAB``⌉ CUDA launches."""
    if on_cpu(x):
        return ref.proj_stage_seeded_ref(x, seed, kt)
    return gemm_nn_seeded(form("proj_stage_seeded", x), x, seed, kt)


@functools.lru_cache(maxsize=256)
def choose_powerpass_schedule(n: int, da: int, db: int, kt: int, *, seeded: bool = False,
                              accumulate: bool = False, dtype: torch.dtype = torch.float32) -> str:
    """``"recompute"`` or ``"staged"`` for ΔY = Aᵀ(B·Q) at a:(n, da),
    b:(n, db), k̃ on operands of ``dtype`` — the reference's order of
    authority without its autotune cache: a one-bucket ΔY recomputes
    (staging would add P's round trip and remove nothing); otherwise the
    cheaper of the two schedules' launch plans under
    :func:`~.matmul.pick_schedule`, tensor-core FLOPs weighted to the f32
    rate (:func:`~.plan.weighted_cost`).  An explicit ``schedule=`` to the
    entry point overrides this.  Memoized per shape: the entry points ask
    on every call."""
    if len(plan.buckets(da, kt)) == 1:
        return "recompute"
    rec = (plan.plan_power_project_accumulate_seeded if seeded
           else plan.plan_power_project_accumulate)(n, da, db, kt, accumulate=accumulate,
                                                    dtype=dtype)
    staged = plan.plan_powerpass_staged(n, da, db, kt, accumulate=accumulate, seeded=seeded,
                                        dtype=dtype)
    return pick_schedule({"recompute": plan.weighted_cost(rec),
                          "staged": plan.weighted_cost(staged)})


def _fused(f, a: torch.Tensor, b: torch.Tensor, q, kt: int,
           out: torch.Tensor | None) -> torch.Tensor:
    """The recompute schedule on the card, by form ``f``: one fused launch
    per ΔY bucket, each projecting P = b·q (q a tensor or a seed) into an
    f32 scratch the launch keeps in L2 and folding rows [r0, r1) of ΔY =
    aᵀP (into ``out`` if given)."""
    (n, da), (n2, db) = a.shape, b.shape
    if n != n2 or (isinstance(q, torch.Tensor) and tuple(q.shape) != (db, kt)):
        raise ValueError(f"{f.label}: shapes a {tuple(a.shape)}, b {tuple(b.shape)} and "
                         f"k̃ = {kt} do not chain")
    _grid_ok(f.label, n, kt)
    _grid_ok(f.label, da, kt)
    if out is not None:
        _check_out(f.label, out, (da, kt), a.device)
    y = torch.empty((da, kt), dtype=torch.float32, device=a.device) if out is None else out
    p = torch.empty((n, kt), dtype=torch.float32, device=a.device)
    for r0, r1 in plan.buckets(da, kt):
        recompute(f, b, q, kt, p, a, y, r0, r1, accumulate=out is not None)
    return y


def power_project_accumulate(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor, *,
                             schedule: str | None = None,
                             out: torch.Tensor | None = None) -> torch.Tensor:
    """ΔY = aᵀ(b·q) in f32.  a: (n, da), b: (n, db), q: (db, k̃) →
    (da, k̃), all f32 or all bf16 (P is f32 either way); with ``out``
    the full contraction is added into it once, as :func:`powerpass_sweep`
    does, and ``out`` is returned.

    ``schedule``: ``"staged"`` (:func:`proj_stage` then
    :func:`powerpass_sweep`, 2 launches), ``"recompute"`` (one fused
    launch per ΔY bucket) or ``None`` (:func:`choose_powerpass_schedule`).
    Bitwise equal on the card: the same FMA chains either way."""
    n, da = a.shape
    kt = q.shape[1]
    host = on_cpu(a, b, q, *(() if out is None else (out,)))
    # the same forms under either schedule
    f = None if host else form("power_project_accumulate", a, b, q)
    sched = (plan.check_schedule(schedule) if schedule is not None else
             choose_powerpass_schedule(n, da, b.shape[1], kt, accumulate=out is not None,
                                       dtype=a.dtype))
    if sched == "staged":
        return powerpass_sweep(a, proj_stage(b, q), out=out)
    if host:
        dY = ref.power_project_accumulate_ref(a, b, q)
        return dY if out is None else out.add_(dY)
    return _fused(f, a, b, q, kt, out)


def power_project_accumulate_seeded(a: torch.Tensor, b: torch.Tensor, seed, kt: int, *,
                                    schedule: str | None = None,
                                    out: torch.Tensor | None = None) -> torch.Tensor:
    """ΔY = aᵀ(b·Ω(seed)), Ω in the data's dtype made on the card;
    bitwise ``power_project_accumulate(a, b, omega_fill(seed, db, kt,
    dtype=b.dtype))`` under either schedule.  Staged:
    :func:`proj_stage_seeded` then the sweep (2 entry-point launches).
    Recompute: per ΔY bucket one call that makes Ω slab by slab and
    contracts every slab but the last with the NN kernel, the last with the
    fused launch (2·⌈db / 4096⌉ CUDA launches)."""
    n, da = a.shape
    host = on_cpu(a, b, *(() if out is None else (out,)))
    f = None if host else form("power_project_accumulate_seeded", a, b)
    sched = (plan.check_schedule(schedule) if schedule is not None else
             choose_powerpass_schedule(n, da, b.shape[1], kt, seeded=True,
                                       accumulate=out is not None, dtype=a.dtype))
    if sched == "staged":
        return powerpass_sweep(a, proj_stage_seeded(b, seed, kt), out=out)
    if host:
        dY = ref.power_project_accumulate_seeded_ref(a, b, seed, kt)
        return dY if out is None else out.add_(dY)
    return _fused(f, a, b, seed, kt, out)
