"""Hand-written CUDA kernels of the port, with their plain versions.

Twelve entry points, one launch counter per operand form, over the CUDA
kernels in ``csrc/gemm_f32.cu``, ``csrc/gemm_bf16.cu``,
``csrc/recompute_f32.cu`` (on the tiles of ``csrc/gemm_ring.cuh`` and
``csrc/gemm_bf16.cuh``), ``csrc/gemm_rows.cu`` and ``csrc/rand.cuh``:

===============================  ============================================
entry point                      replaces (JAX package)
===============================  ============================================
proj_stage                       kernels/powerpass.py ``_proj_stage_kernel``
powerpass_sweep                  kernels/powerpass.py ``_powerpass_sweep_kernel``
gram_sweep                       kernels/projgram.py ``_gram_sweep_kernel``
matmul_tn                        kernels/matmul.py ``_mm_tn_kernel``
matmul_nn                        kernels/matmul.py ``_mm_nn_kernel``
project_rows (serving)           serve/projector.py's XLA ``x @ X`` (no
                                 Pallas kernel): split-K, its bits fixed by K
omega_fill                       kernels/rand.py ``normal_tile``
proj_stage_seeded                kernels/powerpass.py ``_proj_stage_seeded_kernel``
projgram (recompute)             kernels/projgram.py ``_projgram_kernel``
projgram_seeded (recompute)      kernels/projgram.py ``_projgram_seeded_kernel``
power_project_accumulate         kernels/powerpass.py ``_powerpass_kernel``
(recompute)
power_project_accumulate_seeded  kernels/powerpass.py ``_powerpass_seeded_kernel``
(recompute)
===============================  ============================================

Under the staged schedule the fused entry points launch the staged pair
and count there; :mod:`.plan` and the ``choose_*_schedule`` rules decide.
Every entry point but ``project_rows`` (f32: serving casts to f32) also
takes bf16 operands (f32 accumulation and output), counted as e.g.
``proj_stage[bf16]`` or ``powerpass_sweep[bf16,f32]``; the seeded ones and ``omega_fill`` then
make Ω in f32 and round it once to bf16 (``proj_stage_seeded[bf16]``,
``omega_fill[bf16]``).  :data:`.matmul.FORMS` lists every form.
"""

import dataclasses
from typing import Callable

import torch

from . import plan as _plan
from .matmul import FORMS, cuda_form, matmul_nn, matmul_tn, project_rows
from .ops import (chunk_cost, final_pass_chunk, final_pass_chunk_seeded, launch_counts,
                  power_pass_chunk, power_pass_chunk_seeded, reset_launch_counts)
from .powerpass import (choose_powerpass_schedule, power_project_accumulate,
                        power_project_accumulate_seeded, powerpass_sweep, proj_stage,
                        proj_stage_seeded)
from .projgram import choose_projgram_schedule, gram_sweep, projgram, projgram_seeded
from .rand import dense_omega, omega_fill, omega_seeds

_F32, _BF16 = torch.float32, torch.bfloat16
#: The Ω seed words of every seeded probe (``omega_seeds(0)``'s view a).
PROBE_SEED = omega_seeds(0)[0]


@dataclasses.dataclass(frozen=True)
class KernelDef:
    """One operand form of one entry point, for the contract checker
    (:mod:`repro_torch.analysis.kernel_check`).

    ``plan(probe)`` gives the launches one call at the probe's shape
    issues (a fused entry point's: its recompute schedule, the one its own
    kernel runs); ``outputs(probe)`` the call's results as (shape, dtype);
    ``call(probe, device)`` makes the operands from a seed and calls the
    entry point (its plain version on the CPU, its kernel on the card).
    ``probes`` are small shapes, checked and run; ``path`` the main path's
    shapes, whose plans are checked only."""

    name: str
    entry: str
    dtypes: tuple
    plan: Callable
    outputs: Callable
    call: Callable
    probes: tuple
    path: tuple = ()
    seeded: bool = False

    @property
    def fn(self) -> str:
        """The C function of the form (:data:`.matmul.FORMS`)."""
        return FORMS[self.entry][self.dtypes]


def _operands(device, dtypes, *shapes):
    """Seeded N(0, 1) operands of ``shapes`` in ``dtypes`` on ``device``."""
    g = torch.Generator().manual_seed(0)
    return [torch.randn(s, generator=g).to(dtype=dt, device=device)
            for s, dt in zip(shapes, dtypes)]


def _defs(entry, forms, plan, outputs, call, probes, path=(), seeded=False):
    """One :class:`KernelDef` per operand form of ``entry``: ``forms`` maps
    each form's dtypes to its main-path shapes (``path``'s default)."""
    out = {}
    for dtypes, form_path in forms.items():
        name = cuda_form(entry, *dtypes).label
        dt = dtypes[0]
        out[name] = KernelDef(
            name=name, entry=entry, dtypes=dtypes,
            plan=lambda p, _d=dtypes: plan(p, *_d),
            outputs=lambda p, _dt=dt: outputs(p, _dt),
            call=lambda p, device, _d=dtypes: call(p, device, _d),
            probes=probes, path=tuple(form_path if form_path is not None else path),
            seeded=seeded)
    return out


def _registry() -> dict:
    P = _plan
    E, K = 8192, 2 ** 19  # the stream's chunk rows, Europarl's features a view
    small_nn = ({"n": 256, "d": 500, "kt": 64}, {"n": 333, "d": 901, "kt": 67})
    reg = {}
    reg.update(_defs(
        "proj_stage", {(_F32, _F32): None, (_BF16, _BF16): None},
        lambda p, dt, _: P.plan_proj_stage(p["n"], p["d"], p["kt"], dtype=dt),
        lambda p, dt: (((p["n"], p["kt"]), _F32),),
        lambda p, dev, d: (proj_stage(*_operands(dev, d, (p["n"], p["d"]), (p["d"], p["kt"]))),),
        small_nn, ({"n": E, "d": K, "kt": 2060}, {"n": E, "d": K, "kt": 60})))
    reg.update(_defs(
        "matmul_nn", {(_F32, _F32): None, (_BF16, _BF16): None},
        lambda p, dt, _: P.plan_matmul_nn(p["M"], p["K"], p["N"], dtype=dt),
        lambda p, dt: (((p["M"], p["N"]), _F32),),
        lambda p, dev, d: (matmul_nn(*_operands(dev, d, (p["M"], p["K"]), (p["K"], p["N"]))),),
        ({"M": 512, "K": 384, "N": 256}, {"M": 200, "K": 100, "N": 60}),
        ({"M": 4096, "K": 2 ** 18, "N": 2060},)))
    reg.update(_defs(
        "powerpass_sweep",
        {(_F32, _F32): ({"n": E, "da": K, "kt": 2060}, {"n": E, "da": K, "kt": 60}),
         (_BF16, _BF16): ({"n": 4096, "da": 2 ** 18, "kt": 2060},),
         (_BF16, _F32): ({"n": E, "da": K, "kt": 2060},)},
        lambda p, dt, pdt: P.plan_powerpass_sweep(p["n"], p["da"], p["kt"], dtype=dt,
                                                  p_dtype=pdt),
        lambda p, dt: (((p["da"], p["kt"]), _F32),),
        lambda p, dev, d: (powerpass_sweep(*_operands(dev, d, (p["n"], p["da"]),
                                                      (p["n"], p["kt"]))),),
        ({"n": 256, "da": 500, "kt": 64}, {"n": 333, "da": 901, "kt": 67})))
    reg.update(_defs(
        "matmul_tn",
        {(_F32, _F32): ({"K": E, "M": 2060, "N": 2060}, {"K": 4096, "M": 256, "N": 256}),
         (_BF16, _BF16): ({"K": 4096, "M": 2 ** 18, "N": 2060},)},
        lambda p, dt, _: P.plan_matmul_tn(p["K"], p["M"], p["N"], dtype=dt),
        lambda p, dt: (((p["M"], p["N"]), _F32),),
        lambda p, dev, d: (matmul_tn(*_operands(dev, d, (p["K"], p["M"]), (p["K"], p["N"]))),),
        ({"K": 512, "M": 256, "N": 384}, {"K": 200, "M": 60, "N": 100})))
    reg.update(_defs(
        "gram_sweep", {(_F32,): ({"n": E, "kt": 2060},), (_BF16,): ({"n": 4096, "kt": 2060},)},
        lambda p, dt: P.plan_gram_sweep(p["n"], p["kt"], dtype=dt),
        lambda p, dt: (((p["kt"], p["kt"]), _F32),),
        lambda p, dev, d: (gram_sweep(*_operands(dev, d, (p["n"], p["kt"]))),),
        ({"n": 256, "kt": 64}, {"n": 333, "kt": 67})))
    reg.update(_defs(
        "proj_stage_seeded", {(_F32,): None, (_BF16,): None},
        lambda p, dt: P.plan_proj_stage_seeded(p["n"], p["d"], p["kt"], dtype=dt),
        lambda p, dt: (((p["n"], p["kt"]), _F32),),
        lambda p, dev, d: (proj_stage_seeded(*_operands(dev, d, (p["n"], p["d"])), PROBE_SEED,
                                             p["kt"]),),
        # 9001 features: three Ω slabs, the last ragged
        ({"n": 256, "d": 500, "kt": 64}, {"n": 200, "d": 9001, "kt": 67}),
        ({"n": E, "d": K, "kt": 2060},), seeded=True))
    pg_path = ({"n": E, "d": K, "kt": 970}, {"n": E, "d": K, "kt": 2060},
               {"n": 4096, "d": 2048, "kt": 256})
    reg.update(_defs(
        "projgram", {(_F32, _F32): None, (_BF16, _BF16): None},
        lambda p, dt, _: P.plan_projgram(p["n"], p["d"], p["kt"], dtype=dt),
        lambda p, dt: (((p["n"], p["kt"]), _F32), ((p["kt"], p["kt"]), _F32)),
        lambda p, dev, d: projgram(*_operands(dev, d, (p["n"], p["d"]), (p["d"], p["kt"])),
                                   schedule="recompute"),
        # k̃ = 1100: C in two buckets
        ({"n": 256, "d": 500, "kt": 64}, {"n": 130, "d": 300, "kt": 1100}), pg_path))
    reg.update(_defs(
        "projgram_seeded", {(_F32,): None, (_BF16,): None},
        lambda p, dt: P.plan_projgram_seeded(p["n"], p["d"], p["kt"], dtype=dt),
        lambda p, dt: (((p["n"], p["kt"]), _F32), ((p["kt"], p["kt"]), _F32)),
        lambda p, dev, d: projgram_seeded(*_operands(dev, d, (p["n"], p["d"])), PROBE_SEED,
                                          p["kt"], schedule="recompute"),
        ({"n": 256, "d": 500, "kt": 64}, {"n": 200, "d": 9001, "kt": 67}),
        pg_path[:2], seeded=True))
    pa_path = ({"n": E, "da": 1024, "db": K, "kt": 970}, {"n": E, "da": K, "db": K, "kt": 60},
               {"n": 4096, "da": 2048, "db": 1152, "kt": 256})
    reg.update(_defs(
        "power_project_accumulate", {(_F32, _F32, _F32): None, (_BF16, _BF16, _BF16): None},
        lambda p, dt, *_: P.plan_power_project_accumulate(p["n"], p["da"], p["db"], p["kt"],
                                                          dtype=dt),
        lambda p, dt: (((p["da"], p["kt"]), _F32),),
        lambda p, dev, d: (power_project_accumulate(
            *_operands(dev, d, (p["n"], p["da"]), (p["n"], p["db"]), (p["db"], p["kt"])),
            schedule="recompute"),),
        # da = 4096 at k̃ = 512: ΔY in two buckets
        ({"n": 256, "da": 500, "db": 300, "kt": 64},
         {"n": 256, "da": 4096, "db": 256, "kt": 512}), pa_path))
    reg.update(_defs(
        "power_project_accumulate_seeded", {(_F32, _F32): None, (_BF16, _BF16): None},
        lambda p, dt, _: P.plan_power_project_accumulate_seeded(p["n"], p["da"], p["db"],
                                                                p["kt"], dtype=dt),
        lambda p, dt: (((p["da"], p["kt"]), _F32),),
        lambda p, dev, d: (power_project_accumulate_seeded(
            *_operands(dev, d, (p["n"], p["da"]), (p["n"], p["db"])), PROBE_SEED, p["kt"],
            schedule="recompute"),),
        ({"n": 256, "da": 500, "db": 300, "kt": 64},
         {"n": 200, "da": 150, "db": 9001, "kt": 67}), pa_path[:1], seeded=True))
    reg.update(_defs(
        "omega_fill", {(_F32,): None, (_BF16,): None},
        lambda p, dt: P.plan_omega_fill(p["rows"], p["kt"], dtype=dt),
        lambda p, dt: (((p["rows"], p["kt"]), dt),),
        lambda p, dev, d: (omega_fill(PROBE_SEED, p["rows"], p["kt"], dtype=d[0], device=dev),),
        ({"rows": 300, "kt": 70}, {"rows": 4096, "kt": 64}), ({"rows": K, "kt": 2060},),
        seeded=True))
    reg.update(_defs(
        "project_rows", {(_F32, _F32): None},
        lambda p, *_: P.plan_project_rows(p["M"], p["K"], p["N"]),
        lambda p, dt: (((p["M"], p["N"]), _F32),),
        lambda p, dev, d: (project_rows(*_operands(dev, d, (p["M"], p["K"]), (p["K"], p["N"]))),),
        # K = 2500: three segments, the last ragged
        ({"M": 3, "K": 2500, "N": 7}, {"M": 40, "K": 1024, "N": 60}),
        tuple({"M": m, "K": K, "N": 60} for m in (1, 32, 512))))
    return reg


#: The registry the kernel contract checker walks (``python -m
#: repro_torch.analysis kernels``): one :class:`KernelDef` per entry point
#: and operand form of :data:`.matmul.FORMS`, named by the form's launch
#: counter, with its plan builder, its results, a call, small probes and the
#: main path's shapes (PERF.md's kernel table).  Registering a form here is
#: what puts it under the gate.
KERNEL_REGISTRY: dict = _registry()

__all__ = [
    "KERNEL_REGISTRY",
    "KernelDef",
    "choose_powerpass_schedule",
    "choose_projgram_schedule",
    "chunk_cost",
    "dense_omega",
    "final_pass_chunk",
    "final_pass_chunk_seeded",
    "gram_sweep",
    "launch_counts",
    "matmul_nn",
    "matmul_tn",
    "omega_fill",
    "omega_seeds",
    "power_pass_chunk",
    "power_pass_chunk_seeded",
    "power_project_accumulate",
    "power_project_accumulate_seeded",
    "powerpass_sweep",
    "proj_stage",
    "proj_stage_seeded",
    "project_rows",
    "projgram",
    "projgram_seeded",
    "reset_launch_counts",
]
