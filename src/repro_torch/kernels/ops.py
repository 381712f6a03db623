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

On bf16 operands (the sharded fit's ``compute_dtype=torch.bfloat16``)
the launches count under the bf16 form's name — ``proj_stage[bf16]``,
``power_project_accumulate[bf16]``, ``projgram[bf16]`` — except where the
operand is the f32 P: the staged power chunk sweeps with
``powerpass_sweep[bf16,f32]`` (bf16 A, f32 P), and the final chunk's
``gram_sweep`` and ``matmul_tn`` stay f32.  The seeded updates make Ω in
the chunk's dtype (``RCCAConfig.dtype``, the reference's ``q_dtype``): on
bf16 chunks they count as
``proj_stage_seeded[bf16]``, ``power_project_accumulate_seeded[bf16]`` and
``projgram_seeded[bf16]``, beside the sweeps, Grams and cross term of
the unseeded bf16 chunk.

A recompute shape of several buckets counts one launch per bucket.  Each
seeded entry-point launch issues 2·⌈d / 4096⌉ CUDA launches (an
``omega_fill`` and an NN contraction per Ω slab, the last of them the
fused one under recompute); those are not ``omega_fill`` entry-point
launches.  :func:`chunk_cost` reports the modelled FLOPs, bytes and the
resolved schedule of a chunk from the same launch plans the rule reads.

The sharded fit (``core/rcca_dist.py``) calls the single products below
when the mesh's model axis shards the features; a mesh without one takes
:func:`power_pass_chunk` / :func:`final_pass_chunk` as above.  Per rank,
microbatch and pass:

======================  =================================  =================================
collective              power pass                         final pass
======================  =================================  =================================
``unfused``             2 ``matmul_nn`` (:func:`project`)  2 ``matmul_nn`` + 3 ``matmul_tn``
                        + 2 ``matmul_tn``
                        (:func:`accumulate_tn`)
``fused``,              2 ``proj_stage``                   2 ``proj_stage`` +
``fused-int8ef``        (:func:`stage_project`) +          2 ``gram_sweep``
                        2 ``powerpass_sweep``              (:func:`gram_accumulate`) +
                        (:func:`sweep_accumulate`)         1 ``powerpass_sweep``
======================  =================================  =================================

With ``compute_dtype=torch.bfloat16`` every launch in this table is the
bf16 × bf16 form: ``matmul_nn[bf16]``, ``matmul_tn[bf16]``,
``proj_stage[bf16]``, ``gram_sweep[bf16]``, ``powerpass_sweep[bf16]`` —
except under ``fused-int8ef``, whose decoded sum of P is f32 (as in the
reference): its power sweeps are ``powerpass_sweep[bf16,f32]`` and its
final pass's Grams and cross term the f32 ``gram_sweep`` and
``powerpass_sweep``.

``matmul_nn`` and ``proj_stage`` run the same CUDA kernel, as do
``matmul_tn``, ``powerpass_sweep`` and ``gram_sweep``, in each dtype, so
the unfused and fused collectives give the same bits.
"""

from __future__ import annotations

import functools

from . import build, plan
from .matmul import matmul_nn, matmul_tn
from .powerpass import (choose_powerpass_schedule, power_project_accumulate,
                        power_project_accumulate_seeded, powerpass_sweep, proj_stage,
                        proj_stage_seeded)
from .projgram import choose_projgram_schedule, gram_sweep, projgram, projgram_seeded


def project(x, q):
    """P = X·Q, the projection half of the unfused pair (``matmul_nn``)."""
    return matmul_nn(x, q)


def accumulate_tn(x, p):
    """ΔY = Xᵀ·P, the accumulation half of the unfused pair (``matmul_tn``)."""
    return matmul_tn(x, p)


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
    """:func:`power_pass_chunk` against Ω(seed_a), Ω(seed_b) in the chunk's
    dtype, made on the card slab by slab: ΔYa = Aᵀ(B Ω(seed_b)), ΔYb =
    Bᵀ(A Ω(seed_a)).  No (d, k̃) tensor is made."""
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


def stage_project(x, q):
    """The local feature shard's partial P = X_l·Q_l in f32
    (``proj_stage``); the sharded fit sums it over the model axis."""
    return proj_stage(x, q)


def stage_project_seeded(x, seed, *, kt: int):
    """:func:`stage_project` against Ω(seed) made on the card slab by slab
    (``proj_stage_seeded``)."""
    return proj_stage_seeded(x, seed, kt)


def sweep_accumulate(x, p, *, out=None):
    """ΔY = Xᵀ·P over the summed P (``powerpass_sweep``); ``out`` adds it
    into an f32 accumulator in place and returns that."""
    return powerpass_sweep(x, p, out=out)


def gram_accumulate(p):
    """ΔC = Pᵀ·P over the summed P (``gram_sweep``)."""
    return gram_sweep(p)


def _power_view(n, d_out, d_in, kt, seeded, schedule, dtype):
    """(launch plans, resolved schedule) of one view's ΔY update, as the
    engine runs it: accumulating into Y."""
    sched = (plan.check_schedule(schedule) if schedule else
             choose_powerpass_schedule(n, d_out, d_in, kt, seeded=seeded, accumulate=True,
                                       dtype=dtype))
    if sched == "staged":
        return plan.plan_powerpass_staged(n, d_out, d_in, kt, accumulate=True,
                                          seeded=seeded, dtype=dtype), sched
    rec = (plan.plan_power_project_accumulate_seeded if seeded
           else plan.plan_power_project_accumulate)
    return rec(n, d_out, d_in, kt, accumulate=True, dtype=dtype), sched


def _final_view(n, d, kt, seeded, schedule, dtype):
    sched = (plan.check_schedule(schedule) if schedule else
             choose_projgram_schedule(n, d, kt, seeded=seeded, dtype=dtype))
    if sched == "staged":
        return plan.plan_projgram_staged(n, d, kt, seeded=seeded, dtype=dtype), sched
    rec = plan.plan_projgram_seeded if seeded else plan.plan_projgram
    return rec(n, d, kt, dtype=dtype), sched


def _join_schedules(*scheds):
    """One label for the views' choices: the common one, or "a/b" when
    they differ."""
    seen = sorted(set(scheds))
    return seen[0] if len(seen) == 1 else "/".join(seen)


@functools.lru_cache(maxsize=512)
def chunk_cost(kind: str, n: int, da: int, db: int, kt: int, *, engine: str = "kernels",
               seeded: bool = False, schedule: str | None = None,
               dtype=plan.F32) -> dict:
    """Modelled FLOPs and bytes of one chunk update (both views) at
    a:(n, da), b:(n, db), k̃ on operands of ``dtype``, from the port's
    launch plans.

    Returns ``{"flops", "bytes", "kernels": [{"kernel", "calls", "flops",
    "bytes"}, ...], "schedule"}``; ``schedule`` is what the kernels
    resolve for this shape (``schedule`` forces it), None for the torch
    engine, whose launches are PyTorch's and are not modelled.  Memoized
    per shape: treat the returned dict as read-only."""
    if engine != "kernels":
        return {"flops": None, "bytes": None, "kernels": [], "schedule": None}
    if kind == "power":
        pa, sa = _power_view(n, da, db, kt, seeded, schedule, dtype)
        pb, sb = _power_view(n, db, da, kt, seeded, schedule, dtype)
        launches = pa + pb
    elif kind == "final":
        pa, sa = _final_view(n, da, kt, seeded, schedule, dtype)
        pb, sb = _final_view(n, db, kt, seeded, schedule, dtype)
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
