"""Per-chunk data-pass updates, the units the pass engine calls under
``engine="kernels"``.

Port of ``repro/kernels/ops.py``.  Each update takes ``schedule=None``
and passes it to every fused entry point, which then resolves it per view
and shape (``choose_powerpass_schedule`` / ``choose_projgram_schedule``);
``"staged"`` or ``"recompute"`` forces one.  Entry-point launches per
chunk, as :func:`launch_counts` counts them:

============================  ==========================  ===============================
update                        staged                      recompute (one bucket per view)
============================  ==========================  ===============================
:func:`power_pass_chunk`      4: 2 ``proj_stage`` +       2 ``power_project_accumulate``
                              2 ``powerpass_sweep``
:func:`final_pass_chunk`      5: 2 ``proj_stage`` +       3: 2 ``projgram`` +
                              2 ``gram_sweep`` +          ``matmul_tn``
                              ``matmul_tn``
seeded power chunk            4: ``proj_stage_seeded``    2 ``power_project_accumulate_seeded``
                              in place of ``proj_stage``
seeded final chunk            5: as above                 3: 2 ``projgram_seeded`` +
                                                          ``matmul_tn``
============================  ==========================  ===============================

A recompute shape of several buckets counts one launch per bucket.  Each
seeded entry-point launch issues 2·⌈d / 4096⌉ CUDA launches (an
``omega_fill`` and an NN contraction per Ω slab, the last of them the
fused one under recompute); those are not ``omega_fill`` entry-point
launches.  :func:`chunk_cost` reports the modelled FLOPs, bytes and the
resolved schedule of a chunk from the same launch plans the rule reads.
"""

from __future__ import annotations

import functools

from . import build, plan
from .matmul import matmul_tn
from .powerpass import (choose_powerpass_schedule, power_project_accumulate,
                        power_project_accumulate_seeded)
from .projgram import choose_projgram_schedule, projgram, projgram_seeded


def power_pass_chunk(a, b, Qa, Qb, *, schedule=None, out=None):
    """ΔYa = Aᵀ(B Qb), ΔYb = Bᵀ(A Qa) for one row chunk.

    ``out = (Ya, Yb)`` accumulates both into f32 accumulators in place
    (see :func:`repro_torch.kernels.powerpass.powerpass_sweep`) and
    returns them.
    """
    out_a, out_b = (None, None) if out is None else out
    dYa = power_project_accumulate(a, b, Qb, schedule=schedule, out=out_a)
    dYb = power_project_accumulate(b, a, Qa, schedule=schedule, out=out_b)
    return dYa, dYb


def final_pass_chunk(a, b, Qa, Qb, *, schedule=None):
    """ΔCa = PaᵀPa, ΔCb = PbᵀPb, ΔF = PaᵀPb with P = X·Q, for one chunk."""
    pa, Ca = projgram(a, Qa, schedule=schedule)
    pb, Cb = projgram(b, Qb, schedule=schedule)
    return Ca, Cb, matmul_tn(pa, pb)


def power_pass_chunk_seeded(a, b, seed_a, seed_b, *, kt: int, schedule=None, out=None):
    """:func:`power_pass_chunk` against Ω(seed_a), Ω(seed_b) made on the
    card slab by slab: ΔYa = Aᵀ(B Ω(seed_b)), ΔYb = Bᵀ(A Ω(seed_a)).  No
    (d, k̃) tensor is made."""
    out_a, out_b = (None, None) if out is None else out
    dYa = power_project_accumulate_seeded(a, b, seed_b, kt, schedule=schedule, out=out_a)
    dYb = power_project_accumulate_seeded(b, a, seed_a, kt, schedule=schedule, out=out_b)
    return dYa, dYb


def final_pass_chunk_seeded(a, b, seed_a, seed_b, *, kt: int, schedule=None):
    """:func:`final_pass_chunk` against Ω(seed_a), Ω(seed_b) (the q = 0
    direct sketch)."""
    pa, Ca = projgram_seeded(a, seed_a, kt, schedule=schedule)
    pb, Cb = projgram_seeded(b, seed_b, kt, schedule=schedule)
    return Ca, Cb, matmul_tn(pa, pb)


def _power_view(n, d_out, d_in, kt, seeded, schedule):
    """(launch plans, resolved schedule) of one view's ΔY update, as the
    engine runs it: accumulating into Y."""
    sched = (plan.check_schedule(schedule) if schedule else
             choose_powerpass_schedule(n, d_out, d_in, kt, seeded=seeded, accumulate=True))
    if sched == "staged":
        return plan.plan_powerpass_staged(n, d_out, d_in, kt, accumulate=True,
                                          seeded=seeded), sched
    fused = (plan.plan_power_project_accumulate_seeded if seeded
             else plan.plan_power_project_accumulate)
    return fused(n, d_out, d_in, kt, accumulate=True), sched


def _final_view(n, d, kt, seeded, schedule):
    sched = (plan.check_schedule(schedule) if schedule else
             choose_projgram_schedule(n, d, kt, seeded=seeded))
    if sched == "staged":
        return plan.plan_projgram_staged(n, d, kt, seeded=seeded), sched
    return (plan.plan_projgram_seeded if seeded else plan.plan_projgram)(n, d, kt), sched


def _join_schedules(*scheds):
    """One label for the views' choices: the common one, or "a/b" when
    they differ."""
    seen = sorted(set(scheds))
    return seen[0] if len(seen) == 1 else "/".join(seen)


@functools.lru_cache(maxsize=512)
def chunk_cost(kind: str, n: int, da: int, db: int, kt: int, *, engine: str = "kernels",
               seeded: bool = False, schedule: str | None = None) -> dict:
    """Modelled FLOPs and bytes of one chunk update (both views) at
    a:(n, da), b:(n, db), k̃, from the port's launch plans.

    Returns ``{"flops", "bytes", "kernels": [{"kernel", "calls", "flops",
    "bytes"}, ...], "schedule"}``; ``schedule`` is what the kernels
    resolve for this shape (``schedule`` forces it), None for the torch
    engine, whose launches are PyTorch's and are not modelled.  Memoized
    per shape: treat the returned dict as read-only."""
    if engine != "kernels":
        return {"flops": None, "bytes": None, "kernels": [], "schedule": None}
    if kind == "power":
        pa, sa = _power_view(n, da, db, kt, seeded, schedule)
        pb, sb = _power_view(n, db, da, kt, seeded, schedule)
        launches = pa + pb
    elif kind == "final":
        pa, sa = _final_view(n, da, kt, seeded, schedule)
        pb, sb = _final_view(n, db, kt, seeded, schedule)
        launches = pa + pb + plan.plan_matmul_tn(n, kt, kt)
    else:
        raise ValueError(f"unknown pass kind {kind!r}")
    kernels: dict[str, dict] = {}
    for p in launches:
        k = kernels.setdefault(p.kernel, {"kernel": p.kernel, "calls": 0, "flops": 0,
                                          "bytes": 0})
        k["calls"] += 1
        k["flops"] += p.flops
        k["bytes"] += p.bytes
    flops, nbytes = plan.cost(launches)
    return {"flops": flops, "bytes": nbytes, "kernels": list(kernels.values()),
            "schedule": _join_schedules(sa, sb)}


def launch_counts() -> dict[str, int]:
    """Kernel launches per entry point since the last reset."""
    return dict(build.LAUNCHES)


def reset_launch_counts() -> None:
    build.reset_launches()
