"""The final-pass products: (P = X·Q, C = PᵀP), staged or recomputed.

Port of ``repro/kernels/projgram.py``.  Two schedules, bitwise equal:

- *staged*: :func:`~.powerpass.proj_stage` writes P, then
  :func:`gram_sweep` (C = PᵀP, the port of ``_gram_sweep_kernel``: the TN
  kernel with both operands P) reads it back: 2 launches;
- *recompute*: one fused launch per C bucket (``csrc/recompute_f32.cu``,
  the port of ``_projgram_kernel``) projects P and forms its Gram with P
  held in L2 between the phases.

:func:`projgram` picks one per shape (:func:`choose_projgram_schedule`)
unless told; :func:`projgram_seeded` is the same with Ω(seed) made on the
card.  P is returned either way: the cross term F needs it.  On bf16
X and Q (``projgram[bf16]``; seeded: ``projgram_seeded[bf16]``, Ω made in
bf16 slabs) P and C are f32, as in the reference
(``p_dtype=jnp.float32``); :func:`gram_sweep` also takes a bf16 P.
"""

from __future__ import annotations

import functools

import torch

from . import plan, ref
from .matmul import _grid_ok, form, gemm_tn, on_cpu, pick_schedule, recompute
from .powerpass import proj_stage, proj_stage_seeded


def gram_sweep(p: torch.Tensor) -> torch.Tensor:
    """C = pᵀ·p in f32.  p: (n, k̃), f32 or bf16 → (k̃, k̃)."""
    if on_cpu(p):
        return ref.gram_sweep_ref(p)
    return gemm_tn(form("gram_sweep", p), p, p)


@functools.lru_cache(maxsize=256)
def choose_projgram_schedule(n: int, d: int, kt: int, *, seeded: bool = False,
                             dtype: torch.dtype = torch.float32) -> str:
    """``"recompute"`` or ``"staged"`` for (P, PᵀP) at x:(n, d), k̃ on
    operands of ``dtype``: a one-bucket C recomputes, otherwise the
    cheaper plan under :func:`~.matmul.pick_schedule` (the order of
    authority of :func:`~.powerpass.choose_powerpass_schedule`)."""
    if len(plan.buckets(kt, kt)) == 1:
        return "recompute"
    rec = (plan.plan_projgram_seeded if seeded else plan.plan_projgram)(n, d, kt, dtype=dtype)
    staged = plan.plan_projgram_staged(n, d, kt, seeded=seeded, dtype=dtype)
    return pick_schedule({"recompute": plan.weighted_cost(rec),
                          "staged": plan.weighted_cost(staged)})


def _fused(f, x: torch.Tensor, q, kt: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The recompute schedule on the card, by form ``f``: one fused
    launch per C bucket, each projecting P = x·q (q a tensor or a seed)
    into ``p`` (identically each time) and forming rows [r0, r1) of C =
    PᵀP."""
    n, d = x.shape
    if isinstance(q, torch.Tensor) and tuple(q.shape) != (d, kt):
        raise ValueError(f"{f.label}: q must be ({d}, {kt}), got {tuple(q.shape)}")
    _grid_ok(f.label, n, kt)
    p = torch.empty((n, kt), dtype=torch.float32, device=x.device)
    c = torch.empty((kt, kt), dtype=torch.float32, device=x.device)
    for r0, r1 in plan.buckets(kt, kt):
        recompute(f, x, q, kt, p, p, c, r0, r1)
    return p, c


def projgram(x: torch.Tensor, q: torch.Tensor, *,
             schedule: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, C) = (x·q, (x·q)ᵀ(x·q)) in f32.  x: (n, d), q: (d, k̃), both
    f32 or both bf16.

    ``schedule``: ``"staged"`` (2 launches), ``"recompute"`` (one fused
    launch per C bucket; one at k̃ ≤ 1024) or ``None``
    (:func:`choose_projgram_schedule`).  Bitwise equal on the card."""
    n, d = x.shape
    kt = q.shape[1]
    sched = (plan.check_schedule(schedule) if schedule is not None
             else choose_projgram_schedule(n, d, kt, dtype=x.dtype))
    if sched == "staged":
        p = proj_stage(x, q)
        return p, gram_sweep(p)
    if on_cpu(x, q):
        return ref.projgram_ref(x, q)
    return _fused(form("projgram", x, q), x, q, kt)


def projgram_seeded(x: torch.Tensor, seed, kt: int, *,
                    schedule: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, C) with P = x·Ω(seed), Ω in x's dtype made on the card;
    bitwise ``projgram(x, omega_fill(seed, d, kt, dtype=x.dtype))`` under
    either schedule.  Staged:
    :func:`~.powerpass.proj_stage_seeded` then :func:`gram_sweep`.
    Recompute: per C bucket one call that makes Ω slab by slab, the last
    slab contracted by the fused launch (2·⌈d / 4096⌉ CUDA launches)."""
    n, d = x.shape
    sched = (plan.check_schedule(schedule) if schedule is not None
             else choose_projgram_schedule(n, d, kt, seeded=True, dtype=x.dtype))
    if sched == "staged":
        p = proj_stage_seeded(x, seed, kt)
        return p, gram_sweep(p)
    if on_cpu(x):
        return ref.projgram_seeded_ref(x, seed, kt)
    return _fused(form("projgram_seeded", x), x, seed, kt)
