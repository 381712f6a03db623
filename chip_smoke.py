#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout, one H100

Phases, each of which fails the run by raising:

1. device — needs CUDA; prints the card's name and power limit and the
   host's memory (the merge stack's closed groups live there); turns
   TF32 off for every f32 product;
2. build — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (three ``nvcc`` started together), prints ptxas's registers and spills
   for every instance of the staged f32 kernel (``gemm_ring.cuh``), of the
   bf16 wgmma tile (``gemm_bf16.cuh``) and of the fused kernels, f32 (both
   phases on the ring's 128 × 128 tile, each mode pair) and bf16, fails if a
   fused instance spills or if ptxas reports that it serialized the wgmma
   products of a bf16 kernel; counts the HGMMA and HMMA instructions of
   each kernel in ``cuobjdump -sass``: every kernel on the wgmma tile,
   staged or fused, must issue HGMMA, the old mma.sync tile kept as a
   witness HMMA only, the f32 kernels and the generator neither; then the
   occupancy API's blocks per SM of each f32 tile, staged and (128 × 128)
   in the fused f32 kernel, must be the plan's (``plan.F32_TILES``), so
   the printed waves and cooperative grids are the card's, and of the
   wgmma tile and the fused bf16 kernels at their dynamic shared memory
   ``plan.BF16_BLOCKS_PER_SM``;
3. kernels — each of the four GEMM entry points against its plain
   PyTorch version on the card, at the main path's shapes (8192 rows,
   d = 2^19, k̃ = 2060, from the planted generator) and at two ragged
   small shapes: max error, bitwise repeatability, median times beside
   the plain version, one ``torch.matmul`` of the same product
   (yardstick only) and the bound, and the tile ``plan.f32_tile`` picked
   with its tile count and waves; then the fused power pass at the main
   path's k̃ = 2060: one ``power_project_accumulate`` recompute on the
   narrow A (8192 × 1024) BITWISE ``powerpass_sweep(A, proj_stage(B, Q))``
   on the staged kernels, where every operand of both fused phases takes
   the 16-byte copies, and the fused kernel's 128 × 128 tiles and the
   staged stage's 128 × 64 ones both end in a 12-column edge tile;
4. omega — ``omega_fill`` makes the full (2^19, 2060) Ω(seed): within
   8 ulp of the plain generator on the card and, at three slabs, of the
   plain CPU ``dense_omega``; a slab at r0 = 2^18 + 16 is bitwise that
   slice of the full Ω; a ragged (300, 70) Ω padded to (384, 128) has
   exact zeros outside;
5. seeded — ``proj_stage_seeded`` at 8192 × 2^19 → 2060 and one ragged
   shape against its plain version (4·√K·u) and bitwise against
   ``proj_stage(x, omega_fill(seed))``, with times; the library
   yardstick is ``torch.matmul(x, Ω)`` with Ω made beforehand;
6. recompute — the four fused recompute kernels (``projgram``,
   ``projgram_seeded``, ``power_project_accumulate`` with and without
   ``out=``, ``power_project_accumulate_seeded``) at the p = 910 shapes
   (8192 × 2^19 → 970; the power pair's A 8192 × 1024), at a ragged shape
   (333 × 9001 → 67), at one of several buckets and at k̃ = 2060 (the
   staged sweep on the 128 × 64 tile, ragged in rows and contraction): each
   against its plain version (4·√K·u of the largest magnitude) and BITWISE
   against its staged pair (and, seeded, against the materialized
   recompute on ``omega_fill(seed)``), with times beside the staged
   pair's and the library call's, and the ratio of each (phase 2 reads P
   through 4-byte copies at k̃ = 970 and 67, 16-byte ones at 2060);
7. fit — the smoke width on the card (kernels engine, torch engine,
   ``--omega seeded``; both passes resolve to recompute, so the fused
   power-pass kernels run inside a fit), then the main
   path: ``repro_torch.launch.cca_fit`` at Europarl width (da = db =
   2^19, k = 60, p = 2000, q = 1, ν = 0.01, chunk 8192; n cut to
   16 chunks = 131,072 rows for the time limit, two merge groups, so the
   pairwise tree merges full-width stats once), each run with the launch
   counters zeroed just before and read just after: ``engine="kernels"``
   (its peak device memory must stay below the 69.47 GB the merge
   stack reached while it kept closed groups on the card), then
   ``engine="torch"`` on the same data and Ω (their ρ must agree), then
   ``--omega seeded`` and ``--omega seeded-materialized``, whose ρ and
   X must be bitwise equal, at 4 / 5 launches per power / final chunk
   (both passes staged); then the paper's other oversampling, ``--p 910``
   (k̃ = 970), where the final pass recomputes: kernels engine (2
   ``projgram`` + 1 ``matmul_tn`` per final chunk, no ``gram_sweep``)
   against the torch engine, and ``--q 0 --omega seeded`` bitwise
   ``--omega seeded-materialized``;
8. matmul_nn — ``matmul_nn`` (the port of ``_mm_nn_kernel``) at one
   microbatch of one model shard at Europarl width (4096 × 2^18 · 2^18 ×
   2060) and at 333 × 9001 → 67: within 4·√K·u of its plain version,
   bitwise repeatable, bitwise ``proj_stage`` on the same operands, with
   times;
9. dist — the resident sharded fit through ``cca_fit --mode dist``: at
   Europarl width (one 8192-row chunk, p = 2000, microbatch 4096) two
   ranks on a 1 × 1 × 2 mesh share the card over gloo, once per
   collective (``unfused``, ``fused``, ``fused-int8ef``) and once on the
   torch engine: unfused ≡ fused bitwise in ρ and in each rank's Xa and
   Xb, the launches per rank and pass of the ``ops`` table, |Δρ| ≤ 1e-3
   against the torch engine and against stream mode on the same chunk
   and Ω, int8ef within rtol 0.05 / atol 0.02 of fused, each rank's peak
   memory printed; then the smoke width, centered, on four ranks
   (1 × 2 × 2), where the row and the column sums are both real.  The
   ranks are fresh processes, so their launch counters start at 0 in
   each run, and each rank reports its own;
10. bf16 kernels — the eight bf16-operand forms (``proj_stage[bf16]``,
    ``matmul_nn[bf16]``, ``powerpass_sweep[bf16]`` and ``[bf16,f32]``,
    ``matmul_tn[bf16]``, ``gram_sweep[bf16]``, ``projgram[bf16]``,
    ``power_project_accumulate[bf16]``) at four ragged shapes, then at
    the sharded fit's shapes (one Europarl chunk cast to bf16): each
    against its plain version (upcast, f32 products) within 4·√K·u, two
    launches bitwise, and bitwise matmul_nn ≡ proj_stage, matmul_tn ≡
    powerpass_sweep, gram_sweep(P) ≡ matmul_tn(P, P), recompute ≡ staged
    and ``out=`` ≡ acc + ΔY; times beside the plain version, a bf16
    ``torch.matmul`` (yardstick only; for the mixed sweep an f32 one on A
    upcast beforehand) and the bound (tensor-core FLOPs at 989 TFLOP/s,
    f32 ones at 67); then the old mma.sync tile (``gemm_bf16_mma.cuh``,
    which no entry point launches) against the wgmma tile on the same
    operands at ``proj_stage[bf16]``'s main-path shape, the bf16 sweeps'
    and ``gram_sweep[bf16]``'s: "bitwise equal" or the count of differing
    elements and the largest ulp distance, and both tiles' times;
11. dist bf16 — ``cca_fit --mode dist --compute-dtype bfloat16``: at
    Europarl width on 1 × 1 × 2 (``unfused`` ≡ ``fused`` bitwise per rank,
    the bf16 launches per rank and pass, |Δρ| ≤ 1e-3 against the torch
    engine, |ρ_bf16 − ρ_f32| printed) and on 1 × 1 × 1 (the chunk updates:
    ``proj_stage[bf16]`` and ``powerpass_sweep[bf16,f32]``; ρ within 1e-3
    of 1 × 1 × 2); then the smoke width, centered, on four ranks: 1 × 2 × 2
    under all three collectives and 1 × 4 × 1, where both passes
    recompute (``power_project_accumulate[bf16]``, ``projgram[bf16]``);
12. seeded bf16 kernels (right after phase 10) — the bf16 generator
    ``omega_fill[bf16]`` at (2^19, 2060) and at a ragged (300, 70):
    bitwise the card's f32 Ω cast to bf16, each element equal to the plain
    generator's bf16 Ω or one bf16 ulp from it (the count printed), exact
    zeros in the padding; then the three seeded bf16 forms
    (``proj_stage_seeded[bf16]``, ``projgram_seeded[bf16]``,
    ``power_project_accumulate_seeded[bf16]``) at ragged shapes (d of
    three slabs, a last slab of 4 rows, k̃ = 67 and 3), the smoke fit's
    chunk, a shape of 2 C and 23 ΔY buckets, and the main path's shapes:
    each BITWISE its materialized bf16 form on the card's own bf16 Ω
    (``dense_omega(seed, d, k̃, bf16)``), within 4·√K·u of the plain
    product on that same Ω (so the generator's gap is not in it), two
    launches bitwise, recompute ≡ staged and ``out=`` ≡ acc + ΔY; times
    beside the plain seeded version (plain generator included), the
    library yardstick on the Ω made beforehand, and the bound (tensor-core
    FLOPs plus the generator's int32 work);
13. stream bf16 (after phase 7) — ``cca_fit --compute-dtype bfloat16``:
    at Europarl width (p = 2000, 16 chunks, both passes staged)
    ``--omega seeded`` bitwise ``seeded-materialized``, the kernels engine
    against the torch engine (|Δρ| ≤ 1e-3); ``--p 910 --q 0`` seeded
    bitwise its oracle; the smoke width, centered (both passes recompute):
    seeded bitwise its oracle, kernels against torch.  Each fit prints its
    launches by name, schedules, pass times, peak memory and Σρ beside
    the f32 fit's.

Every fit resets the launch counters just before it and reads them just
after, and every kernels-engine stream fit, f32 or bf16, prints the first
16 hex digits of the sha256 of ρ's and of Xa's raw bytes; the total wall
time is printed at the end.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the ``kernels`` JSON, and before that the card's name and power limit.
Without CUDA, or without the repository beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

F32_PEAK_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores (data sheet)
BF16_PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores (data sheet)
# int32 on the CUDA cores: 64 lanes per SM and clock against f32's 128,
# so half the f32 FMA issue rate (33.5e12 FMA/s)
INT32_PEAK_OPS = 16.75e12
HBM_BYTES_PER_S = 3.35e12
U = 2.0 ** -24  # f32 unit roundoff
N_CHUNKS = 16  # two merge groups of 8: the pairwise tree merges once
SEED = 0
# Threefry-2x32-20 (60 add/rotate/xor, 5 two-add key injections, the key
# schedule) and the two exponent patches: int32 operations per Ω element
OMEGA_INT_OPS = 85
OMEGA_ULP_BOUND = 8  # CUDA logf 1 ulp, cosf 2 ulp, one product rounding
# the 16-chunk fit's peak while the merge stack kept closed groups on the card
STACK_ON_CARD_PEAK_GB = 69.47
# Σρ of each stream fit of this run, by its label (run_fit): the bf16 fits
# print their distance to the f32 fit of the same data and Ω
SUM_RHO: dict = {}

# the p = 910 fit's sketch (k = 60) and the power pair's narrow A (one ΔY bucket)
KT_910 = 970
DA_NARROW = 1024

# the sharded fit at Europarl width: one 8192-row chunk on a 1 × 1 × 2 mesh
# (two ranks sharing the card over gloo), two microbatches per pass
DIST_MICROBATCH = 4096
DIST_MESH = "1,1,2"

GEMM = "src/repro_torch/kernels/csrc/gemm_f32.cu"
GEMM_BF16 = "src/repro_torch/kernels/csrc/gemm_bf16.cu"
RECOMPUTE = "src/repro_torch/kernels/csrc/recompute_f32.cu"
FUSED = ("projgram", "projgram_seeded", "power_project_accumulate",
         "power_project_accumulate_seeded")
SOURCES = {name: GEMM for name in ("proj_stage", "powerpass_sweep", "gram_sweep",
                                   "matmul_tn", "proj_stage_seeded", "matmul_nn")}
SOURCES["omega_fill"] = "src/repro_torch/kernels/csrc/rand.cuh"
SOURCES.update({name: RECOMPUTE for name in FUSED})
REPLACES = {
    "proj_stage": "src/repro/kernels/powerpass.py:406",
    "powerpass_sweep": "src/repro/kernels/powerpass.py:445",
    "gram_sweep": "src/repro/kernels/projgram.py:362",
    "matmul_tn": "src/repro/kernels/matmul.py:54",
    "matmul_nn": "src/repro/kernels/matmul.py:34",
    "omega_fill": "src/repro/kernels/rand.py:85",
    "proj_stage_seeded": "src/repro/kernels/powerpass.py:423",
    "projgram": "src/repro/kernels/projgram.py:74",
    "projgram_seeded": "src/repro/kernels/projgram.py:227",
    "power_project_accumulate": "src/repro/kernels/powerpass.py:102",
    "power_project_accumulate_seeded": "src/repro/kernels/powerpass.py:261",
}
# the bf16-operand forms: each row's TPU kernel is its f32 row's
BF16_FORMS = ("proj_stage[bf16]", "matmul_nn[bf16]", "powerpass_sweep[bf16]",
              "matmul_tn[bf16]", "gram_sweep[bf16]", "powerpass_sweep[bf16,f32]",
              "projgram[bf16]", "power_project_accumulate[bf16]")
# the bf16 forms of the three seeded kernels and of the generator they inline
SEEDED_BF16_FORMS = ("proj_stage_seeded[bf16]", "projgram_seeded[bf16]",
                     "power_project_accumulate_seeded[bf16]", "omega_fill[bf16]")
SOURCES.update({name: RECOMPUTE if name.startswith(("projgram", "power_project")) else GEMM_BF16
                for name in BF16_FORMS + SEEDED_BF16_FORMS})
SOURCES["omega_fill[bf16]"] = SOURCES["omega_fill"]
REPLACES.update({name: REPLACES[name.split("[")[0]] for name in BF16_FORMS + SEEDED_BF16_FORMS})


def mem_total() -> str:
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemTotal:"):
            return line.split(":", 1)[1].strip()
    return "unknown"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs after one warm-up,
    each between two CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def cases(a, b, Qa, Qb):
    """Per entry point: (kernel call, plain call, library call, K, flops,
    bytes, output shape) on the main path's operands — P = X·Q staged from
    the chunk.
    C = PᵀP is symmetric, so the Gram's work is its k̃(k̃+1)/2 distinct
    entries: n·k̃·(k̃+1) FLOPs and k̃(k̃+1)/2 words written."""
    from repro_torch.kernels import gram_sweep, matmul_tn, powerpass_sweep, proj_stage, ref

    pa, pb = ref.proj_stage_ref(a, Qa), ref.proj_stage_ref(b, Qb)
    n, da = a.shape
    kt = Qb.shape[1]
    return {
        "proj_stage": (lambda: proj_stage(b, Qb), lambda: ref.proj_stage_ref(b, Qb),
                       lambda: b @ Qb, b.shape[1], 2 * n * b.shape[1] * kt,
                       4 * (n * b.shape[1] + b.shape[1] * kt + n * kt), (n, kt)),
        "powerpass_sweep": (lambda: powerpass_sweep(a, pb),
                            lambda: ref.powerpass_sweep_ref(a, pb), lambda: a.T @ pb,
                            n, 2 * n * da * kt, 4 * (n * da + n * kt + da * kt), (da, kt)),
        "gram_sweep": (lambda: gram_sweep(pb), lambda: ref.gram_sweep_ref(pb),
                       lambda: pb.T @ pb, n, n * kt * (kt + 1),
                       4 * (n * kt + kt * (kt + 1) // 2), (kt, kt)),
        "matmul_tn": (lambda: matmul_tn(pa, pb), lambda: ref.matmul_tn_ref(pa, pb),
                      lambda: pa.T @ pb, n, 2 * n * kt * kt, 4 * (2 * n * kt + kt * kt),
                      (kt, kt)),
    }


def bound(flops: float, nbytes: float, int_ops: float = 0.0, tc_flops: float = 0.0) -> dict:
    """The least time for the work: operations (f32 FLOPs and int32 ops
    both take issue slots; bf16 tensor-core FLOPs at their own rate, the
    times added) against bytes moved once."""
    t_ops = flops / F32_PEAK_FLOPS + int_ops / INT32_PEAK_OPS + tc_flops / BF16_PEAK_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def check(name, kernel, plain, K) -> float:
    """Kernel against plain on the same inputs, and two launches against
    each other; returns the max abs error.  Tolerance: 4·√K·u of the
    plain result's largest magnitude — the statistical growth of f32
    rounding over a K-term sum, whose two orders (the kernel's one
    ascending chain, cuBLAS's blocked sums) differ."""
    import torch

    out, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    err = float((out - want).abs().max())
    scale = float(want.abs().max())
    tol = 4 * math.sqrt(K) * U * scale
    print(f"[smoke] {name} {tuple(out.shape)} K={K}: max_abs_err={err:.3e} "
          f"max_rel_err={err / scale:.3e} (tol {tol / scale:.3e}) "
          f"repeat_bitwise={torch.equal(out, again)}", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    return err


def phase_kernels(dev, a, b) -> dict:
    import torch

    from repro_torch.configs.europarl_cca import config
    from repro_torch.core.rcca import draw_omega
    from repro_torch.kernels import powerpass_sweep, proj_stage

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)
    for n, d, kt in [(1000, 1000, 100), (333, 517, 67)]:  # ragged small shapes
        x = torch.randn((n, d), generator=g, device=dev)
        y = torch.randn((n, d), generator=g, device=dev)
        Qx = torch.randn((d, kt), generator=g, device=dev)
        Qy = torch.randn((d, kt), generator=g, device=dev)
        for name, (kern, plain, _, K, *_) in cases(x, y, Qx, Qy).items():
            check(name, kern, plain, K)

    wl = config()
    Qa, Qb = draw_omega(SEED, wl.da, wl.db, wl.rcca, device=dev)
    rows = {}
    for name, (kern, plain, lib, K, flops, nbytes, shape) in cases(a, b, Qa, Qb).items():
        err = check(name, kern, plain, K)
        print(tile_line(name, *shape), flush=True)
        heavy = flops > 1e12
        reps = 3 if heavy else 10
        t = {"ms": time_ms(kern, reps), "plain_ms": time_ms(plain, reps),
             "library_ms": time_ms(lib, reps)}
        rows[name] = dict(max_abs_err=err, **bound(flops, nbytes), **t)
        print(f"[smoke] {name}: kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
              f"library {t['library_ms']:.3f} ms, bound {rows[name]['bound_ms']:.3f} ms "
              f"({rows[name]['bound_by']}); {flops / t['ms'] / 1e9:.1f} TFLOP/s", flush=True)
    # the main path's form of the sweep: ΔY added into the accumulator in place
    pb = proj_stage(b, Qb)
    acc0 = torch.randn((wl.da, Qb.shape[1]), generator=g, device=dev)
    acc = powerpass_sweep(a, pb, out=acc0.clone())
    if not torch.equal(acc, acc0 + powerpass_sweep(a, pb)):
        raise AssertionError("powerpass_sweep(out=) is not acc + ΔY bitwise")
    print("[smoke] powerpass_sweep(out=acc) == acc + ΔY bitwise: True", flush=True)
    fused_power_witness(a, b, Qb, pb)
    return rows


def fused_power_witness(a, b, q, p) -> None:
    """The fused kernels against the staged ones at the main path's k̃ =
    2060, where both fused phases copy every operand 16 bytes at a time, the
    fused kernel's 128 × 128 tiles end in a 12-column edge tile, and the
    staged stage runs the 128 × 64 tile ``plan.f32_tile`` picks: one fused
    ``power_project_accumulate`` on the narrow A against
    ``powerpass_sweep(A, P)`` with P = ``proj_stage(B, Q)`` (``p``),
    bitwise."""
    import torch

    from repro_torch.kernels import plan, power_project_accumulate, powerpass_sweep

    an = a[:, :DA_NARROW].contiguous()
    kt = q.shape[1]
    # phase 1: B and Q; phase 2: A's first bucket and P (a fresh, aligned tensor)
    vec = (plan.copies((b.data_ptr(), b.shape[1], 4), (q.data_ptr(), kt, 4)),
           plan.copies((an.data_ptr(), DA_NARROW, 4), (0, kt, 4)))
    fused = power_project_accumulate(an, b, q, schedule="recompute")
    staged = powerpass_sweep(an, p)
    same = torch.equal(fused, staged)
    print(tile_line("staged proj_stage", b.shape[0], kt), flush=True)
    print(f"[smoke] fused power pass at k̃ = {kt}, A {tuple(an.shape)}: "
          f"{len(plan.buckets(DA_NARROW, kt))} launches on the "
          f"{'×'.join(map(str, plan.F32_TILES[plan.FUSED_F32_TILE][:2]))} tile, copies "
          f"(plan.copies, 3 = both operands 16 bytes) phase 1 {vec[0]}, phase 2 {vec[1]}; == "
          f"powerpass_sweep(A, proj_stage(B, Q)) bitwise: {same}", flush=True)
    if vec != (3, 3):
        raise AssertionError("the k̃ = 2060 fused power pass does not take the 16-byte copies")
    if not same:
        raise AssertionError("the fused power pass is not its staged pair bitwise at k̃ = 2060")


def ulp(x, y):
    """Largest distance in f32 ulps between two f32 tensors (an order-
    preserving integer map of the bits)."""
    import torch

    def key(v):
        i = v.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((key(x) - key(y)).abs().max())


def phase_omega(dev) -> dict:
    """omega_fill at the main path's Ω, against the plain generator."""
    import torch

    from repro_torch.configs.europarl_cca import config
    from repro_torch.kernels import rand

    wl = config()
    d, kt = wl.db, wl.rcca.sketch
    seed = rand.omega_seeds(SEED)[1]
    full, again = (rand.omega_fill(seed, d, kt, device=dev) for _ in range(2))
    plain = rand.omega_tile(seed, d, kt, device=dev)
    torch.cuda.synchronize()
    err_ulp = ulp(full, plain)
    err = float((full - plain).abs().max())
    print(f"[smoke] omega_fill ({d}, {kt}): max {err_ulp} ulp (bound {OMEGA_ULP_BOUND}), "
          f"max_abs_err={err:.3e} against the plain generator on the card; "
          f"repeat_bitwise={torch.equal(full, again)}", flush=True)
    if not err_ulp <= OMEGA_ULP_BOUND or not torch.equal(full, again):
        raise AssertionError("omega_fill disagrees with its plain version")
    for r0, rows in [(0, 2048), (2**18 + 16, 4096), (d - 1000, 1000)]:
        want = rand.omega_tile(seed, d, kt, r0=r0, rows=rows, device="cpu")
        slab = rand.omega_fill(seed, d, kt, r0=r0, rows=rows, device=dev)
        u = ulp(slab.cpu(), want)
        print(f"[smoke] omega_fill slab r0={r0} rows={rows}: max {u} ulp against the plain "
              f"CPU dense_omega; bitwise the slice of the full Ω: "
              f"{torch.equal(slab, full[r0:r0 + rows])}", flush=True)
        if not u <= OMEGA_ULP_BOUND or not torch.equal(slab, full[r0:r0 + rows]):
            raise AssertionError(f"omega_fill slab at r0={r0} is wrong")
    pad = rand.omega_fill(seed, 300, 70, rows=384, cols=128, device=dev).cpu()
    pad_want = rand.omega_tile(seed, 300, 70, rows=384, cols=128, device="cpu")
    pad_ok = (bool((pad[300:] == 0).all()) and bool((pad[:, 70:] == 0).all())
              and ulp(pad, pad_want) <= OMEGA_ULP_BOUND)
    print(f"[smoke] omega_fill ragged (300, 70) padded to (384, 128): exact zeros outside "
          f"and within bound inside: {pad_ok}", flush=True)
    if not pad_ok:
        raise AssertionError("omega_fill's ragged edge is wrong")
    t = {"ms": time_ms(lambda: rand.omega_fill(seed, d, kt, device=dev), 10),
         "plain_ms": time_ms(lambda: rand.omega_tile(seed, d, kt, device=dev), 3),
         "library_ms": None}
    row = dict(max_abs_err=err, **bound(0, 4 * d * kt, OMEGA_INT_OPS * d * kt), **t)
    print(f"[smoke] omega_fill: kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
          f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}); no library call makes "
          "this Ω", flush=True)
    return row


def phase_seeded(dev, b) -> dict:
    """proj_stage_seeded at the main path's shape and a ragged one."""
    import torch

    from repro_torch.configs.europarl_cca import config
    from repro_torch.kernels import proj_stage, proj_stage_seeded, rand, ref
    from repro_torch.kernels.matmul import SEEDED_SLAB

    wl = config()
    kt = wl.rcca.sketch
    seed = rand.omega_seeds(SEED)[1]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 11)
    small = torch.randn((333, 9001), generator=g, device=dev)
    for x, k in [(small, 67), (b, kt)]:  # the main path's shape last
        n, d = x.shape
        err = check("proj_stage_seeded", lambda: proj_stage_seeded(x, seed, k),
                    lambda: ref.proj_stage_seeded_ref(x, seed, k), d)
        omega = rand.omega_fill(seed, d, k, device=dev)
        same = torch.equal(proj_stage_seeded(x, seed, k), proj_stage(x, omega))
        print(f"[smoke] proj_stage_seeded(x, seed) == proj_stage(x, omega_fill(seed)) "
              f"bitwise at {tuple(x.shape)} → {k}: {same}", flush=True)
        if not same:
            raise AssertionError("proj_stage_seeded is not the materialized stage bitwise")
    t = {"ms": time_ms(lambda: proj_stage_seeded(b, seed, kt), 3),
         "plain_ms": time_ms(lambda: ref.proj_stage_seeded_ref(b, seed, kt), 3),
         "library_ms": time_ms(lambda: b @ omega, 3)}
    flops = 2 * n * d * kt
    row = dict(max_abs_err=err, **bound(flops, 4 * (n * d + n * kt), OMEGA_INT_OPS * d * kt),
               **t)
    print(tile_line("proj_stage_seeded slab", n, kt), flush=True)
    print(f"[smoke] proj_stage_seeded: kernel {t['ms']:.3f} ms "
          f"({2 * -(-d // SEEDED_SLAB)} CUDA launches), plain {t['plain_ms']:.3f} ms, "
          f"library {t['library_ms']:.3f} ms (torch.matmul(x, Ω), Ω made beforehand), "
          f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}); "
          f"{flops / t['ms'] / 1e9:.1f} TFLOP/s", flush=True)
    return row


def check_fused(name, rec, staged, plain, Ks) -> float:
    """A recompute kernel (``rec`` returns a tuple of outputs) against its
    plain version per output (4·√K·u of the plain output's largest
    magnitude, K per output in ``Ks``: d for P, d + n for what P feeds),
    against its staged pair BITWISE, and two launches bitwise; returns
    the largest abs error."""
    import torch

    out, again, pair, want = rec(), rec(), staged(), plain()
    torch.cuda.synchronize()
    worst = 0.0
    for i, (o, g, s, w, K) in enumerate(zip(out, again, pair, want, Ks)):
        if not torch.isfinite(o).all():
            raise AssertionError(f"{name}[{i}]: non-finite output")
        err = float((o - w).abs().max())
        scale = float(w.abs().max())
        tol = 4 * math.sqrt(K) * U * scale
        same, repeat = torch.equal(o, s), torch.equal(o, g)
        print(f"[smoke] {name}[{i}] {tuple(o.shape)} K={K}: max_abs_err={err:.3e} "
              f"max_rel_err={err / scale:.3e} (tol {tol / scale:.3e}) "
              f"staged_bitwise={same} repeat_bitwise={repeat}", flush=True)
        if not err <= tol:
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
        if not same:
            raise AssertionError(f"{name}: recompute is not its staged pair bitwise")
        if not repeat:
            raise AssertionError(f"{name}: two launches on the same inputs differ")
        worst = max(worst, err)
    return worst


def fused_cases(x, q, a, seed):
    """Per fused entry point on x (n, d), q (d, k̃) and a (n, da) — the
    power pair's A, with B = x: (recompute call, staged call, plain call,
    library call or None, the K of each output, FLOPs, bytes, int32 ops),
    each call returning a tuple.  The Gram's FLOPs and bytes count its
    k̃(k̃+1)/2 distinct entries, as ``gram_sweep``'s bound does."""
    import torch

    from repro_torch.kernels import (power_project_accumulate, power_project_accumulate_seeded,
                                     projgram, projgram_seeded, rand, ref)

    n, d = x.shape
    kt, da = q.shape[1], a.shape[1]
    gram_flops, gram_words = n * kt * (kt + 1), kt * (kt + 1) // 2
    proj_flops = 2 * n * d * kt
    power_flops = proj_flops + 2 * n * da * kt
    omega = rand.omega_fill(seed, d, kt, device=x.device)
    omega_ops = OMEGA_INT_OPS * d * kt
    return {
        "projgram": (lambda: projgram(x, q, schedule="recompute"),
                     lambda: projgram(x, q, schedule="staged"),
                     lambda: ref.projgram_ref(x, q), None, (d, d + n),
                     proj_flops + gram_flops, 4 * (n * d + d * kt + n * kt + gram_words), 0),
        "projgram_seeded": (lambda: projgram_seeded(x, seed, kt, schedule="recompute"),
                            lambda: projgram_seeded(x, seed, kt, schedule="staged"),
                            lambda: ref.projgram_seeded_ref(x, seed, kt), None, (d, d + n),
                            proj_flops + gram_flops, 4 * (n * d + n * kt + gram_words),
                            omega_ops),
        "power_project_accumulate": (
            lambda: (power_project_accumulate(a, x, q, schedule="recompute"),),
            lambda: (power_project_accumulate(a, x, q, schedule="staged"),),
            lambda: (ref.power_project_accumulate_ref(a, x, q),),
            lambda: torch.linalg.multi_dot([a.T, x, q]), (d + n,), power_flops,
            4 * (n * d + d * kt + n * da + da * kt), 0),
        "power_project_accumulate_seeded": (
            lambda: (power_project_accumulate_seeded(a, x, seed, kt, schedule="recompute"),),
            lambda: (power_project_accumulate_seeded(a, x, seed, kt, schedule="staged"),),
            lambda: (ref.power_project_accumulate_seeded_ref(a, x, seed, kt),),
            lambda: torch.linalg.multi_dot([a.T, x, omega]), (d + n,), power_flops,
            4 * (n * d + n * da + da * kt), omega_ops),
    }, omega


def fused_extras(x, q, a, seed, omega) -> None:
    """The contracts beside the staged pair: seeded ≡ the materialized
    recompute on ``omega_fill(seed)``, and ``out=`` ≡ acc + ΔY, both
    bitwise, both schedules."""
    import torch

    from repro_torch.kernels import (power_project_accumulate, power_project_accumulate_seeded,
                                     projgram, projgram_seeded)

    kt = q.shape[1]
    seeded = projgram_seeded(x, seed, kt, schedule="recompute")
    mat = projgram(x, omega, schedule="recompute")
    ok = [torch.equal(s, m) for s, m in zip(seeded, mat)]
    dy_s = power_project_accumulate_seeded(a, x, seed, kt, schedule="recompute")
    dy = power_project_accumulate(a, x, omega, schedule="recompute")
    ok.append(torch.equal(dy_s, dy))
    g = torch.Generator(device=x.device)
    g.manual_seed(SEED + 13)
    acc0 = torch.randn((a.shape[1], kt), generator=g, device=x.device)
    for fn, op in [(power_project_accumulate, q), (power_project_accumulate_seeded, seed)]:
        args = (a, x, op) if fn is power_project_accumulate else (a, x, op, kt)
        rec = fn(*args, schedule="recompute", out=acc0.clone())
        staged = fn(*args, schedule="staged", out=acc0.clone())
        ok += [torch.equal(rec, staged), torch.equal(rec, acc0 + fn(*args, schedule="recompute"))]
    print(f"[smoke] fused at {tuple(x.shape)} → {kt}, A {tuple(a.shape)}: seeded == "
          f"materialized recompute on omega_fill (P, C, ΔY) {ok[:3]}; out=acc: recompute == "
          f"staged and == acc + ΔY (materialized, seeded) {ok[3:]}", flush=True)
    if not all(ok):
        raise AssertionError("a fused kernel broke a bitwise contract")


def phase_recompute(dev, a, b) -> dict:
    """The four fused recompute kernels at a ragged shape, at a shape of
    several buckets, then at the p = 910 shapes with times."""
    import torch

    from repro_torch.kernels import choose_powerpass_schedule, plan, rand

    seed = rand.omega_seeds(SEED)[1]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 17)
    # (n, d, k̃, da): ragged; then 2 C buckets (k̃ = 1100) and 23 ΔY buckets;
    # then k̃ = 2060, where the staged sweep takes the 128 × 64 tile
    for n, d, kt, da in [(333, 9001, 67, 517), (333, 9001, 1100, 20000),
                         (333, 9001, 2060, 20000)]:
        x = torch.randn((n, d), generator=g, device=dev)
        q = torch.randn((d, kt), generator=g, device=dev)
        xa = torch.randn((n, da), generator=g, device=dev)
        print(f"[smoke] fused at {(n, d, kt, da)}: {len(plan.buckets(kt, kt))} C bucket(s), "
              f"{len(plan.buckets(da, kt))} ΔY bucket(s)", flush=True)
        print(tile_line("staged sweep", da, kt), flush=True)
        cases, omega = fused_cases(x, q, xa, seed)
        for name, (rec, staged, plain, _, Ks, *_) in cases.items():
            check_fused(name, rec, staged, plain, Ks)
        fused_extras(x, q, xa, seed, omega)
        del x, q, xa, omega, cases

    n, d = b.shape
    q = torch.randn((d, KT_910), generator=g, device=dev)
    a_narrow = a[:, :DA_NARROW].contiguous()
    cases, omega = fused_cases(b, q, a_narrow, seed)
    fused_extras(b, q, a_narrow, seed, omega)
    print(tile_line("fused P (and the staged pair's P)", n, KT_910), flush=True)
    rows = {}
    for name, (rec, staged, plain, lib, Ks, flops, nbytes, int_ops) in cases.items():
        err = check_fused(name, rec, staged, plain, Ks)
        t = {"ms": time_ms(rec, 3), "staged_ms": time_ms(staged, 3),
             "plain_ms": time_ms(plain, 3),
             "library_ms": None if lib is None else time_ms(lib, 3)}
        rows[name] = dict(max_abs_err=err, **bound(flops, nbytes, int_ops), **t)
        lib_txt = ("none" if lib is None else
                   f"{t['library_ms']:.3f} ms (fused ÷ library {t['ms'] / t['library_ms']:.3f})")
        print(f"[smoke] {name} at {(n, d)} → {KT_910}: kernel {t['ms']:.3f} ms, staged pair "
              f"{t['staged_ms']:.3f} ms (fused ÷ staged {t['ms'] / t['staged_ms']:.3f}), plain "
              f"{t['plain_ms']:.3f} ms, library {lib_txt}, bound "
              f"{rows[name]['bound_ms']:.3f} ms ({rows[name]['bound_by']}); "
              f"{flops / t['ms'] / 1e9:.1f} TFLOP/s", flush=True)
    # the p = 910 power pass at full width (da = 2^19): the rule stages it;
    # a recompute would issue one launch per ΔY bucket, each the narrow
    # pair's one-bucket launch timed above
    from repro_torch.kernels import power_project_accumulate

    n_buckets = len(plan.buckets(a.shape[1], KT_910))
    staged_ms = time_ms(lambda: power_project_accumulate(a, b, q, schedule="staged"), 3)
    print(f"[smoke] p=910 power pass per view and chunk, A {tuple(a.shape)}: staged "
          f"{staged_ms:.3f} ms; recompute {n_buckets} launches ≈ "
          f"{n_buckets * rows['power_project_accumulate']['ms'] / 1e3:.1f} s "
          f"({n_buckets} × the one-bucket launch); rule: "
          f"{choose_powerpass_schedule(*a.shape, b.shape[1], KT_910, accumulate=True)}",
          flush=True)
    return rows


def phase_matmul_nn(dev, a) -> dict:
    """matmul_nn at one microbatch of one model shard at Europarl width
    (4096 × 2^18 · 2^18 × 2060) and at a ragged shape: against its plain
    version, bitwise repeatable, bitwise ``proj_stage`` on the same
    operands, with times."""
    import torch

    from repro_torch.kernels import matmul_nn, proj_stage, ref

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 19)
    small = torch.randn((333, 9001), generator=g, device=dev)
    x = a[:DIST_MICROBATCH, :a.shape[1] // 2].contiguous()
    for xi, kt in [(small, 67), (x, 2060)]:  # the main path's shape last
        q = torch.randn((xi.shape[1], kt), generator=g, device=dev)
        err = check("matmul_nn", lambda: matmul_nn(xi, q), lambda: ref.matmul_nn_ref(xi, q),
                    xi.shape[1])
        same = torch.equal(matmul_nn(xi, q), proj_stage(xi, q))
        print(f"[smoke] matmul_nn == proj_stage bitwise at {tuple(xi.shape)} → {kt}: {same}",
              flush=True)
        if not same:
            raise AssertionError("matmul_nn is not proj_stage bitwise")
    (M, K), N = x.shape, q.shape[1]
    flops = 2 * M * K * N
    t = {"ms": time_ms(lambda: matmul_nn(x, q), 3),
         "plain_ms": time_ms(lambda: ref.matmul_nn_ref(x, q), 3),
         "library_ms": time_ms(lambda: torch.matmul(x, q), 3)}
    row = dict(max_abs_err=err, **bound(flops, 4 * (M * K + K * N + M * N)), **t)
    print(f"[smoke] matmul_nn at {(M, K)} → {N}: kernel {t['ms']:.3f} ms, plain "
          f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.3f} ms, bound "
          f"{row['bound_ms']:.3f} ms ({row['bound_by']}); {flops / t['ms'] / 1e9:.1f} TFLOP/s",
          flush=True)
    print(tile_line("matmul_nn", M, N), flush=True)
    return row


def check_form(name, call, plain, Ks, pair=None, pair_name=None) -> float:
    """A bf16 form (``call`` returns a tuple of outputs) against its plain
    version per output (4·√K·u of the plain output's largest magnitude,
    the f32 rows' bound), two launches bitwise, and, where given, BITWISE
    against ``pair`` (the entry point the form must equal); returns the
    largest abs error."""
    import torch

    out, again, want = call(), call(), plain()
    other = pair() if pair is not None else None
    torch.cuda.synchronize()
    worst = 0.0
    for i, (o, g, w, K) in enumerate(zip(out, again, want, Ks)):
        if not torch.isfinite(o).all():
            raise AssertionError(f"{name}[{i}]: non-finite output")
        err = float((o - w).abs().max())
        scale = float(w.abs().max())
        tol = 4 * math.sqrt(K) * U * scale
        repeat = torch.equal(o, g)
        same = True if other is None else torch.equal(o, other[i])
        print(f"[smoke] {name}[{i}] {tuple(o.shape)} K={K}: max_abs_err={err:.3e} "
              f"max_rel_err={err / scale:.3e} (tol {tol / scale:.3e}) repeat_bitwise={repeat}"
              + ("" if other is None else f" == {pair_name} bitwise: {same}"), flush=True)
        if not err <= tol:
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
        if not repeat:
            raise AssertionError(f"{name}: two launches on the same inputs differ")
        if not same:
            raise AssertionError(f"{name}: not {pair_name} bitwise")
        worst = max(worst, err)
    return worst


def bf16_forms(x, q, a, xm, qm, q2, an):
    """The eight bf16 forms on their operands, all bf16: the stage's x (n,
    d) and q (d, k̃); the sweep's A, a (n, da), against the f32 P =
    x·q; one model shard's microbatch xm (nm, dm) and qm (dm, k̃), whose
    P pm = xm·qm rounded to bf16 the sharded sweeps take; the recompute
    sketch q2 (d, k̃₂) with the narrow A an (n, da₂).  Per form: (kernel
    call, plain call, library call or None, K per output, tensor-core
    FLOPs, f32 FLOPs, bytes, bitwise pair or None, its name), each call
    returning a tuple.  The Gram counts its k̃(k̃+1)/2 distinct entries."""
    import torch

    from repro_torch.kernels import (gram_sweep, matmul_nn, matmul_tn,
                                     power_project_accumulate, powerpass_sweep, proj_stage,
                                     projgram, ref)

    (n, d), kt, da = x.shape, q.shape[1], a.shape[1]
    (nm, dm), kt2, da2 = xm.shape, q2.shape[1], an.shape[1]
    p32 = proj_stage(x, q)
    pm = proj_stage(xm, qm).to(torch.bfloat16)
    return {
        "proj_stage[bf16]": (lambda: (proj_stage(x, q),), lambda: (ref.proj_stage_ref(x, q),),
                             lambda: torch.matmul(x, q), (d,), 2 * n * d * kt, 0,
                             2 * (n * d + d * kt) + 4 * n * kt, None, None),
        "matmul_nn[bf16]": (lambda: (matmul_nn(xm, qm),), lambda: (ref.matmul_nn_ref(xm, qm),),
                            lambda: torch.matmul(xm, qm), (dm,), 2 * nm * dm * kt, 0,
                            2 * (nm * dm + dm * kt) + 4 * nm * kt,
                            lambda: (proj_stage(xm, qm),), "proj_stage[bf16]"),
        "powerpass_sweep[bf16]": (lambda: (powerpass_sweep(xm, pm),),
                                  lambda: (ref.powerpass_sweep_ref(xm, pm),),
                                  lambda: torch.matmul(xm.T, pm), (nm,), 2 * nm * dm * kt, 0,
                                  2 * (nm * dm + nm * kt) + 4 * dm * kt, None, None),
        "matmul_tn[bf16]": (lambda: (matmul_tn(xm, pm),), lambda: (ref.matmul_tn_ref(xm, pm),),
                            lambda: torch.matmul(xm.T, pm), (nm,), 2 * nm * dm * kt, 0,
                            2 * (nm * dm + nm * kt) + 4 * dm * kt,
                            lambda: (powerpass_sweep(xm, pm),), "powerpass_sweep[bf16]"),
        "gram_sweep[bf16]": (lambda: (gram_sweep(pm),), lambda: (ref.gram_sweep_ref(pm),),
                             lambda: torch.matmul(pm.T, pm), (nm,), nm * kt * (kt + 1), 0,
                             2 * nm * kt + 4 * (kt * (kt + 1) // 2),
                             lambda: (matmul_tn(pm, pm),), "matmul_tn[bf16](P, P)"),
        "powerpass_sweep[bf16,f32]": (lambda: (powerpass_sweep(a, p32),),
                                      lambda: (ref.powerpass_sweep_ref(a, p32),), None, (n,),
                                      0, 2 * n * da * kt, 2 * n * da + 4 * (n * kt + da * kt),
                                      None, None),
        "projgram[bf16]": (lambda: projgram(x, q2, schedule="recompute"),
                           lambda: ref.projgram_ref(x, q2), None, (d, d + n),
                           2 * n * d * kt2, n * kt2 * (kt2 + 1),
                           2 * (n * d + d * kt2) + 4 * (n * kt2 + kt2 * (kt2 + 1) // 2),
                           lambda: projgram(x, q2, schedule="staged"), "its staged pair"),
        "power_project_accumulate[bf16]": (
            lambda: (power_project_accumulate(an, x, q2, schedule="recompute"),),
            lambda: (ref.power_project_accumulate_ref(an, x, q2),),
            lambda: torch.linalg.multi_dot([an.T, x, q2]), (d + n,), 2 * n * d * kt2,
            2 * n * da2 * kt2, 2 * (n * d + d * kt2 + n * da2) + 4 * da2 * kt2,
            lambda: (power_project_accumulate(an, x, q2, schedule="staged"),),
            "its staged pair"),
    }, p32, pm


def bf16_out_contract(a, p, label) -> None:
    """``powerpass_sweep(out=acc)`` is acc + ΔY bitwise, for this P dtype."""
    import torch

    from repro_torch.kernels import powerpass_sweep

    g = torch.Generator(device=a.device)
    g.manual_seed(SEED + 23)
    acc0 = torch.randn((a.shape[1], p.shape[1]), generator=g, device=a.device)
    same = torch.equal(powerpass_sweep(a, p, out=acc0.clone()), acc0 + powerpass_sweep(a, p))
    print(f"[smoke] {label}(out=acc) == acc + ΔY bitwise: {same}", flush=True)
    if not same:
        raise AssertionError(f"{label}(out=) is not acc + ΔY bitwise")


def mma_witness(x, q, tn: bool):
    """The old mma.sync tile (``csrc/gemm_bf16_mma.cuh``), which no entry
    point launches: Y = x·q, or xᵀ·q when ``tn``, f32, by its own C entry;
    uncounted."""
    import torch

    from repro_torch.kernels import build

    K, M = x.shape if tn else x.shape[::-1]
    N = q.shape[1]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    rc = build.build()["gemm_bf16"].gemm_bf16_mma_witness(
        x.data_ptr(), q.data_ptr(), y.data_ptr(), M, N, K, int(tn),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gemm_bf16_mma_witness failed with CUDA error {rc}")
    return y


def bf16_tile_witness(x, q, xm, pm) -> dict:
    """The wgmma tile against the old mma.sync tile on the same operands, at
    ``proj_stage[bf16]``'s main-path shape (x·q, tile 1), at the bf16
    sweeps' (xmᵀ·pm, tile 2) and at ``gram_sweep[bf16]``'s (pmᵀ·pm): per
    shape "bitwise equal" or the count of differing elements and the largest
    distance in f32 ulps, and both tiles' times.  The two agree only if a
    wgmma k16 product from zero has an mma.sync m16n8k16's bits; no contract
    rests on that.  Returns the old tile's ms per shape."""
    import torch

    from repro_torch.kernels import gram_sweep, matmul_tn, proj_stage

    old_ms = {}
    for label, new, old, reps in [
            ("proj_stage[bf16]", lambda: proj_stage(x, q), lambda: mma_witness(x, q, False), 3),
            ("matmul_tn[bf16]", lambda: matmul_tn(xm, pm), lambda: mma_witness(xm, pm, True), 3),
            ("gram_sweep[bf16]", lambda: gram_sweep(pm), lambda: mma_witness(pm, pm, True), 10)]:
        a, b = new(), old()
        torch.cuda.synchronize()
        differ = int((a != b).sum())
        verdict = ("bitwise equal" if differ == 0 else
                   f"{differ} of {a.numel()} elements differ, by at most {ulp(a, b)} f32 ulp")
        del a, b
        t_new, t_old = time_ms(new, reps), time_ms(old, reps)
        old_ms[label] = t_old
        print(f"[smoke] old-tile witness, {label} shape: wgmma tile vs mma.sync tile "
              f"{verdict}; wgmma {t_new:.3f} ms, mma.sync {t_old:.3f} ms", flush=True)
    return old_ms


def phase_bf16_kernels(dev, a16, b16) -> dict:
    """The bf16-operand forms (``csrc/gemm_bf16.cu``; the fused ones in
    ``csrc/recompute_f32.cu``) at three ragged shapes, then at the sharded
    fit's shapes with times: each against its plain version (upcast, f32
    products) within 4·√K·u, two launches bitwise, and the in-port
    contracts bitwise — matmul_nn ≡ proj_stage, matmul_tn ≡
    powerpass_sweep (bf16 P), gram_sweep(P) ≡ matmul_tn(P, P), recompute ≡
    staged, ``out=`` ≡ acc + ΔY.  ``a16``, ``b16``: one Europarl chunk in
    bf16.  The library yardstick is ``torch.matmul`` on the same bf16
    operands, which writes bf16."""
    import torch

    from repro_torch.configs.europarl_cca import config
    from repro_torch.core.rcca import draw_omega

    bf16 = torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 29)
    # (n, d, k̃, da): odd widths (rows 2-byte aligned), k̃ = 970 (4-byte),
    # k̃ = 2060 (8-byte), and a contraction shorter than one stage
    for n, d, kt, da in [(333, 517, 67, 301), (200, 1000, 970, 129), (130, 4100, 2060, 517),
                         (5, 37, 3, 9)]:
        x, q, a = (torch.randn(shape, generator=g, device=dev).to(bf16)
                   for shape in ((n, d), (d, kt), (n, da)))
        forms, p32, pm = bf16_forms(x, q, a, x, q, q, a)
        print(f"[smoke] bf16 forms at (n, d, k̃, da) = {(n, d, kt, da)}", flush=True)
        for name, (call, plain, _, Ks, _, _, _, pair, pair_name) in forms.items():
            check_form(name, call, plain, Ks, pair, pair_name)
        bf16_out_contract(a, p32, "powerpass_sweep[bf16,f32]")
        bf16_out_contract(x, pm, "powerpass_sweep[bf16]")
        del x, q, a, forms, p32, pm

    wl = config()
    Qa, Qb = draw_omega(SEED, wl.da, wl.db, wl.rcca, device=dev)
    q, qm = Qb.to(bf16), Qa[:wl.da // 2].to(bf16)
    del Qa, Qb
    q2 = torch.randn((b16.shape[1], KT_910), generator=g, device=dev).to(bf16)
    xm = a16[:DIST_MICROBATCH, :a16.shape[1] // 2].contiguous()
    an = a16[:, :DA_NARROW].contiguous()
    forms, p32, pm = bf16_forms(b16, q, a16, xm, qm, q2, an)
    bf16_out_contract(a16, p32, "powerpass_sweep[bf16,f32]")
    bf16_out_contract(xm, pm, "powerpass_sweep[bf16]")
    rows = {}
    for name, (call, plain, lib, Ks, tc_flops, flops, nbytes, pair, pair_name) in forms.items():
        err = check_form(name, call, plain, Ks, pair, pair_name)
        torch.cuda.empty_cache()
        heavy = tc_flops + flops > 1e12
        reps = 3 if heavy else 10
        t = {"ms": time_ms(call, reps), "plain_ms": time_ms(plain, reps),
             "library_ms": None if lib is None else time_ms(lib, reps)}
        if name == "powerpass_sweep[bf16,f32]":
            # the yardstick on A upcast to f32 beforehand, as the seeded rows'
            # on an Ω made beforehand
            a32 = a16.float()
            t["library_ms"] = time_ms(lambda: torch.matmul(a32.T, p32), reps)
            del a32
            print(tile_line(name, a16.shape[1], p32.shape[1]), flush=True)
        if pair_name == "its staged pair":
            t["staged_ms"] = time_ms(pair, reps)
        rows[name] = dict(max_abs_err=err, **bound(flops, nbytes, tc_flops=tc_flops), **t)
        lib_txt = ("none" if t["library_ms"] is None else
                   f"{t['library_ms']:.3f} ms ({'f32 A upcast' if lib is None else 'bf16 out'})")
        staged_txt = (f", staged pair {t['staged_ms']:.3f} ms (fused ÷ staged "
                      f"{t['ms'] / t['staged_ms']:.3f})" if "staged_ms" in t else "")
        print(f"[smoke] {name}: kernel {t['ms']:.3f} ms{staged_txt}, plain "
              f"{t['plain_ms']:.3f} ms, library {lib_txt}, bound {rows[name]['bound_ms']:.3f} "
              f"ms ({rows[name]['bound_by']}); {(tc_flops + flops) / t['ms'] / 1e9:.1f} TFLOP/s",
              flush=True)
    bf16_tile_witness(b16, q, xm, pm)
    return rows


def run_fit(argv, label):
    """One main-path run of the launcher: counters zeroed just before,
    read just after; returns (report, launches, peak GB, wall s)."""
    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.launch import cca_fit

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = cca_fit.main(argv)
    wall = time.perf_counter() - t0
    launches = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    SUM_RHO[label] = float(rep.result.rho.double().sum())
    print(f"[smoke] {label}: wall {wall:.3f} s, passes {rep.pass_seconds} s, "
          f"schedules {rep.pass_schedules}, peak memory {peak:.2f} GB, launches {launches}, "
          f"sum rho {SUM_RHO[label]:.6f}", flush=True)
    if "torch" not in argv:  # a kernels-engine fit, f32 or bf16
        print(f"[smoke] {label}: sha256 rho {digest(rep.result.rho)}, Xa "
              f"{digest(rep.result.Xa)}", flush=True)
    return rep, launches, peak, wall


def digest(t) -> str:
    """The first 16 hex digits of the sha256 of a tensor's raw bytes."""
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def fit_checks(rep, label, want_launches, want_schedules):
    """A fit's launches and resolved schedules per pass, as predicted."""
    if rep.pass_launches != want_launches:
        raise AssertionError(f"{label}: launches per pass {rep.pass_launches}, "
                             f"want {want_launches}")
    if rep.pass_schedules != want_schedules:
        raise AssertionError(f"{label}: schedules per pass {rep.pass_schedules}, "
                             f"want {want_schedules}")


def rho_ok(rho) -> bool:
    """Finite and in [0, 1]: ρ ≤ 1 holds exactly for λ > 0; 1e-5 leaves
    room for the f32 statistics only (f32 factorizations in finish
    overshot by 2e-4)."""
    import torch

    return bool((torch.isfinite(rho) & (rho >= 0) & (rho <= 1 + 1e-5)).all())


def phase_smoke_fits(dev) -> dict:
    """The smoke width on the card, where both passes recompute: kernels
    engine, torch engine, ``--omega seeded``, each against the exact
    dense CCA; returns the fused power-pass kernels' launches."""
    from repro_torch.configs.europarl_cca import smoke_config
    from repro_torch.launch import cca_fit

    argv = ["--smoke", "--device", dev.type, "--seed", str(SEED)]
    reps = {}
    for label, extra in [("smoke, kernels engine", []), ("smoke, torch engine",
                                                         ["--engine", "torch"]),
                         ("smoke, omega=seeded", ["--omega", "seeded"])]:
        rep, launches, _, _ = run_fit(argv + extra, label)
        ev = cca_fit.evaluate(rep, smoke_config(), seed=SEED, device=dev)
        print(f"[smoke] {label}: feasibility {ev['feasibility']}, "
              f"exact-oracle gap {ev['gap']:.5f}", flush=True)
        if max(ev["feasibility"].values()) > 1e-4 or not 0 <= ev["gap"] < 0.05:
            raise AssertionError(f"{label}: infeasible or far from the exact CCA")
        reps[label] = (rep, launches)
    rep_k, launches_k = reps["smoke, kernels engine"]
    rep_t, launches_t = reps["smoke, torch engine"]
    rep_s, launches_s = reps["smoke, omega=seeded"]
    nc = rep_k.n_chunks
    final = {"projgram": 2 * nc, "matmul_tn": nc}  # 3 per chunk
    fit_checks(rep_k, "smoke kernels", [{"power_project_accumulate": 2 * nc}, final],
               ["recompute", "recompute"])
    fit_checks(rep_s, "smoke seeded", [{"power_project_accumulate_seeded": 2 * nc}, final],
               ["recompute", "recompute"])
    fit_checks(rep_t, "smoke torch", [{}, {}], [None, None])
    gap = float((rep_k.result.rho.double() - rep_t.result.rho.double()).abs().max())
    print(f"[smoke] smoke width: max |rho_kernels - rho_torch| = {gap:.3e} (limit 1e-3)",
          flush=True)
    if not gap <= 1e-3 or not rho_ok(rep_k.result.rho) or not rho_ok(rep_s.result.rho):
        raise AssertionError("smoke-width fits disagree or leave [0, 1]")
    return {"power_project_accumulate": launches_k["power_project_accumulate"],
            "power_project_accumulate_seeded": launches_s["power_project_accumulate_seeded"]}


def phase_fit(dev) -> dict:
    """The main path's four Europarl-width runs at p = 2000 (both passes
    staged); returns each kernel's launches in the run that drives it."""
    import torch

    from repro_torch.configs.europarl_cca import config

    wl = config()
    argv = ["--device", dev.type, "--n-chunks", str(N_CHUNKS), "--seed", str(SEED)]
    print(f"[smoke] main path: Europarl width, n cut to {N_CHUNKS} chunks of 8192 rows "
          "(the time limit's cut)", flush=True)
    rep_k, launches, peak_k, _ = run_fit(argv + ["--engine", "kernels"], "kernels engine")
    nc = rep_k.n_chunks
    want_power = {"proj_stage": 2 * nc, "powerpass_sweep": 2 * nc}  # 4 per chunk
    want_final = {"proj_stage": 2 * nc, "gram_sweep": 2 * nc, "matmul_tn": nc}  # 5 per chunk
    fit_checks(rep_k, "kernels engine", [want_power, want_final], ["staged", "staged"])
    if not peak_k < STACK_ON_CARD_PEAK_GB:
        raise AssertionError(f"peak memory {peak_k:.2f} GB: closed merge groups are not "
                             f"leaving the card ({STACK_ON_CARD_PEAK_GB} GB when they stay)")
    rho_k = rep_k.result.rho.double().cpu()
    Xa_shape = tuple(rep_k.result.Xa.shape)
    finite = all(bool(torch.isfinite(t).all()) for t in rep_k.result[:3])
    del rep_k

    rep_t, launches_t, _, _ = run_fit(argv + ["--engine", "torch"], "torch engine")
    if launches_t:
        raise AssertionError("the torch engine launched a kernel")
    rho_t = rep_t.result.rho.double().cpu()
    del rep_t
    gap = float((rho_k - rho_t).abs().max())
    print(f"[smoke] max |rho_kernels - rho_torch| = {gap:.3e} (limit 1e-3); "
          f"sum rho {float(rho_k.sum()):.6f} vs {float(rho_t.sum()):.6f}", flush=True)
    if not finite or Xa_shape != (wl.da, wl.rcca.k) or rho_k.shape != (wl.rcca.k,):
        raise AssertionError(f"bad fit output: finite={finite} Xa {Xa_shape}")
    if not rho_ok(rho_k):
        raise AssertionError("canonical correlations outside [0, 1]")
    if not gap <= 1e-3:
        raise AssertionError("kernels and torch engines disagree on rho")

    # the seeded path and its bitwise oracle
    rep_s, launches_s, peak_s, _ = run_fit(argv + ["--omega", "seeded"], "omega=seeded")
    want_seeded = {"proj_stage_seeded": 2 * nc, "powerpass_sweep": 2 * nc}  # 4 per chunk
    fit_checks(rep_s, "omega=seeded", [want_seeded, want_final], ["staged", "staged"])
    seeded = [t.cpu() for t in rep_s.result[:3]]
    del rep_s
    rep_m, launches_m, peak_m, _ = run_fit(argv + ["--omega", "seeded-materialized"],
                                           "omega=seeded-materialized")
    # Ω for both views up front, then 4 per power chunk
    fit_checks(rep_m, "omega=seeded-materialized",
               [{"omega_fill": 2, **want_power}, want_final], ["staged", "staged"])
    oracle = [t.cpu() for t in rep_m.result[:3]]
    del rep_m
    same = [torch.equal(x, y) for x, y in zip(seeded, oracle)]
    rho_s = seeded[2].double()
    print(f"[smoke] seeded vs seeded-materialized bitwise (Xa, Xb, rho): {same}; "
          f"sum rho {float(rho_s.sum()):.6f}; max |rho_seeded - rho_kernels| = "
          f"{float((rho_s - rho_k).abs().max()):.3e} (another Ω)", flush=True)
    print(f"[smoke] peak device memory, 16 chunks: materialized {peak_k:.2f} GB, "
          f"seeded {peak_s:.2f} GB, seeded-materialized {peak_m:.2f} GB "
          f"(closed groups kept on the card: {STACK_ON_CARD_PEAK_GB} GB)", flush=True)
    if not all(same):
        raise AssertionError("omega=seeded is not bitwise omega=seeded-materialized")
    if not rho_ok(rho_s):
        raise AssertionError("seeded fit's canonical correlations are not in [0, 1]")
    if not peak_s < peak_k:
        raise AssertionError("the seeded fit held more device memory than the materialized one")
    return {**launches, "omega_fill": launches_m.get("omega_fill", 0),
            "proj_stage_seeded": launches_s.get("proj_stage_seeded", 0)}


def phase_fit_910(dev) -> dict:
    """The paper's p = 910 at Europarl width (k̃ = 970): the power pass
    stays staged, the final pass recomputes; kernels engine against the
    torch engine, then the q = 0 seeded fit bitwise its oracle.  Returns
    the fused projgram kernels' launches."""
    import torch

    argv = ["--device", dev.type, "--n-chunks", str(N_CHUNKS), "--seed", str(SEED),
            "--p", "910"]
    print("[smoke] p = 910: Europarl width, k̃ = 970, n cut as above", flush=True)
    rep_k, launches_k, peak_k, _ = run_fit(argv, "p=910 kernels engine")
    nc = rep_k.n_chunks
    final = {"projgram": 2 * nc, "matmul_tn": nc}  # 3 per chunk, no gram_sweep
    fit_checks(rep_k, "p=910 kernels", [{"proj_stage": 2 * nc, "powerpass_sweep": 2 * nc},
                                        final], ["staged", "recompute"])
    rho_k = rep_k.result.rho.double().cpu()
    del rep_k
    rep_t, launches_t, peak_t, _ = run_fit(argv + ["--engine", "torch"], "p=910 torch engine")
    rho_t = rep_t.result.rho.double().cpu()
    del rep_t
    gap = float((rho_k - rho_t).abs().max())
    print(f"[smoke] p=910: max |rho_kernels - rho_torch| = {gap:.3e} (limit 1e-3); sum rho "
          f"{float(rho_k.sum()):.6f} vs {float(rho_t.sum()):.6f}; peak {peak_k:.2f} / "
          f"{peak_t:.2f} GB", flush=True)
    if launches_t or not gap <= 1e-3 or not rho_ok(rho_k):
        raise AssertionError("p=910: the engines disagree, or rho leaves [0, 1]")

    q0 = argv + ["--q", "0"]
    rep_s, launches_s, peak_s, _ = run_fit(q0 + ["--omega", "seeded"], "p=910 q=0 seeded")
    fit_checks(rep_s, "p=910 q=0 seeded", [{"projgram_seeded": 2 * nc, "matmul_tn": nc}],
               ["recompute"])
    seeded = [t.cpu() for t in rep_s.result[:3]]
    del rep_s
    rep_m, _, peak_m, _ = run_fit(q0 + ["--omega", "seeded-materialized"],
                                  "p=910 q=0 seeded-materialized")
    fit_checks(rep_m, "p=910 q=0 seeded-materialized", [{"omega_fill": 2, **final}],
               ["recompute"])
    oracle = [t.cpu() for t in rep_m.result[:3]]
    del rep_m
    same = [torch.equal(x, y) for x, y in zip(seeded, oracle)]
    print(f"[smoke] p=910 q=0 seeded vs seeded-materialized bitwise (Xa, Xb, rho): {same}; "
          f"sum rho {float(seeded[2].double().sum()):.6f}; peak {peak_s:.2f} / {peak_m:.2f} GB",
          flush=True)
    if not all(same) or not rho_ok(seeded[2]):
        raise AssertionError("p=910 q=0: seeded is not bitwise its oracle, or rho leaves [0, 1]")
    return {"projgram": launches_k["projgram"],
            "projgram_seeded": launches_s["projgram_seeded"]}


def run_dist(argv, label):
    """One dist-mode run of the launcher; the ranks are fresh processes
    whose launch counters start at 0.  Returns the report."""
    import torch

    from repro_torch.launch import cca_fit

    torch.cuda.empty_cache()  # the ranks need the card; this process holds nothing
    t0 = time.perf_counter()
    rep = cca_fit.main(["--mode", "dist", "--device", "cuda", "--seed", str(SEED)] + argv)
    print(f"[smoke] {label}: wall {time.perf_counter() - t0:.3f} s, backend {rep.backend}, "
          f"ranks on {rep.devices}, peak memory per rank "
          f"{[round(r['peak_gb'], 2) for r in rep.ranks]} GB", flush=True)
    return rep


def dist_launches(collective: str, nb: int, bf16: bool = False) -> list:
    """Entry-point launches per rank and pass (power, final) with nb
    microbatches, under a real model axis (``ops`` docstring).  In bf16
    every product is the bf16 form, but int8ef's decoded sum of P is f32:
    its sweeps take an f32 P."""
    t = "[bf16]" if bf16 else ""
    if collective == "unfused":
        return [{f"matmul_nn{t}": 2 * nb, f"matmul_tn{t}": 2 * nb},
                {f"matmul_nn{t}": 2 * nb, f"matmul_tn{t}": 3 * nb}]
    if bf16 and collective == "fused-int8ef":
        return [{"proj_stage[bf16]": 2 * nb, "powerpass_sweep[bf16,f32]": 2 * nb},
                {"proj_stage[bf16]": 2 * nb, "gram_sweep": 2 * nb, "powerpass_sweep": nb}]
    return [{f"proj_stage{t}": 2 * nb, f"powerpass_sweep{t}": 2 * nb},
            {f"proj_stage{t}": 2 * nb, f"gram_sweep{t}": 2 * nb, f"powerpass_sweep{t}": nb}]


def dist_checks(reps: dict, nb: int, label: str, bf16: bool = False) -> None:
    """unfused ≡ fused bitwise (ρ, each rank's Xa and Xb), launches per
    rank and pass, int8ef within the reference's tolerance of fused."""
    import numpy as np

    for coll in ("unfused", "fused", "fused-int8ef"):
        for r in reps[coll].ranks:
            want = dist_launches(coll, nb, bf16)
            if r["pass_launches"] != want:
                raise AssertionError(f"{label} {coll} rank {r['rank']}: launches "
                                     f"{r['pass_launches']}, want {want}")
    u, f, i8 = (reps[c] for c in ("unfused", "fused", "fused-int8ef"))
    same = [np.array_equal(ru["rho"], rf["rho"]) and ru["digest"] == rf["digest"]
            for ru, rf in zip(u.ranks, f.ranks)]
    rho_f, rho_i8 = f.result.rho.numpy(), i8.result.rho.numpy()
    close = bool(np.allclose(rho_i8, rho_f, rtol=0.05, atol=0.02))
    print(f"[smoke] {label}: unfused == fused bitwise per rank (rho, Xa, Xb): {same}; "
          f"fused-int8ef vs fused max |Δrho| {np.abs(rho_i8 - rho_f).max():.3e} "
          f"(rtol 0.05, atol 0.02): {close}", flush=True)
    if not all(same):
        raise AssertionError(f"{label}: unfused and fused collectives differ")
    if not close:
        raise AssertionError(f"{label}: fused-int8ef is outside its tolerance")
    for rep in (u, f, i8):
        if not rho_ok(rep.result.rho):
            raise AssertionError(f"{label}: rho leaves [0, 1]")


def phase_dist(dev) -> dict:
    """The sharded fit through ``cca_fit --mode dist``: at Europarl width
    (one 8192-row chunk, p = 2000) two ranks on a 1 × 1 × 2 mesh share
    the card over gloo, each collective on the kernels engine, then the
    torch engine, then stream mode on the same chunk and Ω; then the
    smoke width, centered, on four ranks (1 × 2 × 2), where the row and
    the column sums are both real.  Returns matmul_nn's launches and the
    fused run's ρ."""
    import numpy as np
    import torch

    from repro_torch.launch import cca_fit

    argv = ["--mesh", DIST_MESH, "--n-chunks", "1", "--microbatch", str(DIST_MICROBATCH)]
    print(f"[smoke] dist: Europarl width, n = 8192 (one chunk), mesh {DIST_MESH}, "
          f"microbatch {DIST_MICROBATCH}", flush=True)
    reps = {c: run_dist(argv + ["--collective", c], f"dist {c}")
            for c in ("unfused", "fused", "fused-int8ef")}
    nb = 8192 // DIST_MICROBATCH
    dist_checks(reps, nb, "dist Europarl")
    rep_t = run_dist(argv + ["--engine", "torch"], "dist torch engine")
    if any(r["pass_launches"] != [{}, {}] for r in rep_t.ranks):
        raise AssertionError("the torch engine launched a kernel")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rep_s = cca_fit.main(["--device", "cuda", "--seed", str(SEED), "--n-chunks", "1"])
    rho_s = rep_s.result.rho.double().cpu().numpy()
    del rep_s
    rho_f = reps["fused"].result.rho.numpy()
    gap_t = float(np.abs(rho_f - rep_t.result.rho.numpy()).max())
    gap_s = float(np.abs(rho_f - rho_s).max())
    print(f"[smoke] dist Europarl: max |rho_kernels - rho_torch| = {gap_t:.3e}, max "
          f"|rho_dist - rho_stream| = {gap_s:.3e} (limits 1e-3); sum rho {rho_f.sum():.6f}, "
          f"stream {rho_s.sum():.6f}; lam_a {reps['fused'].result.diagnostics['lam_a']:.6g}",
          flush=True)
    if not gap_t <= 1e-3 or not gap_s <= 1e-3:
        raise AssertionError("dist Europarl: the fit disagrees with the torch engine or "
                             "with stream mode")

    smoke = ["--smoke", "--center", "--ranks", "4", "--mesh", "1,2,2"]
    print("[smoke] dist: smoke width, centered, 4 ranks on 1 × 2 × 2", flush=True)
    sreps = {c: run_dist(smoke + ["--collective", c], f"dist smoke {c}")
             for c in ("unfused", "fused", "fused-int8ef")}
    dist_checks(sreps, 1, "dist smoke")
    torch.cuda.reset_peak_memory_stats()
    rep_ss = cca_fit.main(["--smoke", "--center", "--device", "cuda", "--seed", str(SEED)])
    gap = float(np.abs(sreps["fused"].result.rho.numpy()
                       - rep_ss.result.rho.double().cpu().numpy()).max())
    print(f"[smoke] dist smoke: max |rho_dist - rho_stream| = {gap:.3e} (limit 1e-3)",
          flush=True)
    if not gap <= 1e-3:
        raise AssertionError("dist smoke: the fit disagrees with stream mode")
    return {"matmul_nn": sum(r["pass_launches"][0]["matmul_nn"]
                             + r["pass_launches"][1]["matmul_nn"]
                             for r in reps["unfused"].ranks)}, rho_f


def same_per_rank(a, b) -> list:
    """ρ and each rank's Xa, Xb digests equal, rank by rank."""
    import numpy as np

    return [np.array_equal(ra["rho"], rb["rho"]) and ra["digest"] == rb["digest"]
            for ra, rb in zip(a.ranks, b.ranks)]


def launches_of(reps, names) -> dict:
    """Each name's launches, summed over the ranks and passes of ``reps``."""
    return {n: sum(p.get(n, 0) for rep in reps for r in rep.ranks for p in r["pass_launches"])
            for n in names}


def phase_dist_bf16(dev, rho_f32) -> dict:
    """The sharded fit at ``--compute-dtype bfloat16``: at Europarl width
    (one chunk, microbatch 4096) two ranks on 1 × 1 × 2 sharing the card,
    ``unfused`` and ``fused`` on the kernels engine (bitwise equal per
    rank; the bf16 launches of the ``ops`` table), then the torch engine
    (|Δρ| ≤ 1e-3); one rank on 1 × 1 × 1, where the chunk updates run
    ``proj_stage[bf16]`` and ``powerpass_sweep[bf16,f32]`` (ρ within 1e-3
    of the two-rank fused run); then the smoke width on four ranks,
    centered: 1 × 2 × 2 under all three collectives and 1 × 4 × 1, where
    both passes recompute (ρ within 1e-3 of 1 × 2 × 2 fused).  ``rho_f32``:
    the f32 fused run's ρ at Europarl width, for |ρ_bf16 − ρ_f32|.
    Returns each bf16 form's launches in the runs that drive it."""
    import numpy as np

    bf16 = ["--compute-dtype", "bfloat16"]
    argv = ["--mesh", DIST_MESH, "--n-chunks", "1", "--microbatch", str(DIST_MICROBATCH)] + bf16
    print(f"[smoke] dist bf16: Europarl width, n = 8192 (one chunk), mesh {DIST_MESH}, "
          f"microbatch {DIST_MICROBATCH}", flush=True)
    reps = {c: run_dist(argv + ["--collective", c], f"dist bf16 {c}")
            for c in ("unfused", "fused")}
    nb = 8192 // DIST_MICROBATCH
    for coll, rep in reps.items():
        for r in rep.ranks:
            want = dist_launches(coll, nb, bf16=True)
            if r["pass_launches"] != want or r["compute_dtype"] != "bfloat16":
                raise AssertionError(f"dist bf16 {coll} rank {r['rank']}: launches "
                                     f"{r['pass_launches']}, want {want}")
    same = same_per_rank(reps["unfused"], reps["fused"])
    rep_t = run_dist(argv + ["--engine", "torch"], "dist bf16 torch engine")
    if any(r["pass_launches"] != [{}, {}] for r in rep_t.ranks):
        raise AssertionError("the torch engine launched a kernel")
    rep_1 = run_dist(["--mesh", "1,1,1", "--n-chunks", "1", "--microbatch",
                      str(DIST_MICROBATCH)] + bf16, "dist bf16 1 x 1 x 1")
    want_1 = [{"proj_stage[bf16]": 2 * nb, "powerpass_sweep[bf16,f32]": 2 * nb},
              {"proj_stage[bf16]": 2 * nb, "gram_sweep": 2 * nb, "matmul_tn": nb}]
    if rep_1.ranks[0]["pass_launches"] != want_1:
        raise AssertionError(f"dist bf16 1 x 1 x 1: launches "
                             f"{rep_1.ranks[0]['pass_launches']}, want {want_1}")
    rho_f = reps["fused"].result.rho.numpy()
    gap_t = float(np.abs(rho_f - rep_t.result.rho.numpy()).max())
    gap_1 = float(np.abs(rho_f - rep_1.result.rho.numpy()).max())
    gap_32 = float(np.abs(rho_f - rho_f32).max())
    print(f"[smoke] dist bf16 Europarl: unfused == fused bitwise per rank (rho, Xa, Xb): "
          f"{same}; max |rho_kernels - rho_torch| = {gap_t:.3e}, max |rho_1x1x1 - "
          f"rho_1x1x2| = {gap_1:.3e} (limits 1e-3); max |rho_bf16 - rho_f32| = {gap_32:.3e} "
          f"(fused); sum rho {rho_f.sum():.6f} (f32 {rho_f32.sum():.6f})", flush=True)
    if not all(same):
        raise AssertionError("dist bf16 Europarl: unfused and fused collectives differ")
    if not gap_t <= 1e-3 or not gap_1 <= 1e-3:
        raise AssertionError("dist bf16 Europarl: the fit disagrees with the torch engine or "
                             "with one rank")
    for rep in (*reps.values(), rep_t, rep_1):
        if not rho_ok(rep.result.rho):
            raise AssertionError("dist bf16 Europarl: rho leaves [0, 1]")

    smoke = ["--smoke", "--center", "--ranks", "4"] + bf16
    print("[smoke] dist bf16: smoke width, centered, 4 ranks on 1 × 2 × 2 and 1 × 4 × 1",
          flush=True)
    sreps = {c: run_dist(smoke + ["--mesh", "1,2,2", "--collective", c], f"dist bf16 smoke {c}")
             for c in ("unfused", "fused", "fused-int8ef")}
    dist_checks(sreps, 1, "dist bf16 smoke", bf16=True)
    rep_r = run_dist(smoke + ["--mesh", "1,4,1"], "dist bf16 smoke 1 x 4 x 1")
    want_r = [{"power_project_accumulate[bf16]": 2}, {"projgram[bf16]": 2, "matmul_tn": 1}]
    if any(r["pass_launches"] != want_r for r in rep_r.ranks):
        raise AssertionError(f"dist bf16 smoke 1 x 4 x 1: launches "
                             f"{[r['pass_launches'] for r in rep_r.ranks]}, want {want_r}")
    gap = float(np.abs(rep_r.result.rho.numpy() - sreps["fused"].result.rho.numpy()).max())
    print(f"[smoke] dist bf16 smoke: max |rho_1x4x1 - rho_1x2x2| = {gap:.3e} (limit 1e-3)",
          flush=True)
    if not gap <= 1e-3 or not rho_ok(rep_r.result.rho):
        raise AssertionError("dist bf16 smoke: 1 x 4 x 1 disagrees with 1 x 2 x 2")
    return {**launches_of([reps["unfused"]], ["matmul_nn[bf16]", "matmul_tn[bf16]"]),
            **launches_of([reps["fused"]], ["proj_stage[bf16]", "powerpass_sweep[bf16]",
                                            "gram_sweep[bf16]"]),
            **launches_of([rep_1], ["powerpass_sweep[bf16,f32]"]),
            **launches_of([rep_r], ["projgram[bf16]", "power_project_accumulate[bf16]"])}


def bf16_ulps(x, y) -> tuple[int, int, bool]:
    """(elements that differ, largest distance in bf16 ulps, signs equal)
    between two bf16 tensors: with equal signs, the 16-bit patterns of
    neighbouring bf16 values differ by one."""
    import torch

    xi, yi = (t.contiguous().view(torch.int16).to(torch.int32) for t in (x, y))
    differ = int((xi != yi).sum())
    return differ, int((xi - yi).abs().max()), bool(((xi < 0) == (yi < 0)).all())


def phase_omega_bf16(dev) -> dict:
    """The bf16 generator (``omega_fill[bf16]``, §D.1) at the main path's
    Ω and at a ragged (300, 70) padded to (384, 128): bitwise the card's
    f32 Ω cast to bf16; against the plain generator's bf16 Ω, each element
    equal or one bf16 ulp apart (the f32 elements may differ by up to
    OMEGA_ULP_BOUND f32 ulps, and one rounding turns such a gap into one
    bf16 ulp at rare elements; the count is printed); exact zeros in the
    padding; two launches bitwise."""
    import torch

    from repro_torch.configs.europarl_cca import config
    from repro_torch.kernels import rand

    bf16 = torch.bfloat16
    wl = config()
    d, kt = wl.db, wl.rcca.sketch
    seed = rand.omega_seeds(SEED)[1]
    for dd, kk, rows, cols in [(d, kt, d, kt), (300, 70, 384, 128)]:
        kw = dict(rows=rows, cols=cols, device=dev)
        om16, again = (rand.omega_fill(seed, dd, kk, dtype=bf16, **kw) for _ in range(2))
        cast = rand.omega_fill(seed, dd, kk, **kw).to(bf16)
        plain = rand.omega_tile(seed, dd, kk, **kw).to(bf16)
        torch.cuda.synchronize()
        differ, max_ulp, same_sign = bf16_ulps(om16, plain)
        zeros = bool((om16[dd:] == 0).all()) and bool((om16[:, kk:] == 0).all())
        ok = [torch.equal(om16, cast), max_ulp <= 1 and same_sign, zeros,
              torch.equal(om16, again)]
        err = float((om16.float() - plain.float()).abs().max())
        print(f"[smoke] omega_fill[bf16] ({dd}, {kk}) as ({rows}, {cols}): == omega_fill(f32)"
              f".to(bf16) bitwise {ok[0]}; against the plain generator's bf16 Ω {differ} of "
              f"{dd * kk} elements differ, by at most {max_ulp} bf16 ulp (bound 1), same signs "
              f"{same_sign}, max_abs_err={err:.3e}; exact zeros outside {ok[2]}; "
              f"repeat_bitwise={ok[3]}", flush=True)
        if not all(ok):
            raise AssertionError("omega_fill[bf16] disagrees with the cast f32 Ω or the plain "
                                 "generator, or its padding is not zero")
        if rows == d:
            row_err = err
        del om16, again, cast, plain
    t = {"ms": time_ms(lambda: rand.omega_fill(seed, d, kt, dtype=bf16, device=dev), 10),
         "plain_ms": time_ms(lambda: rand.omega_tile(seed, d, kt, device=dev).to(bf16), 3),
         "library_ms": None}
    row = dict(max_abs_err=row_err, **bound(0, 2 * d * kt, OMEGA_INT_OPS * d * kt), **t)
    print(f"[smoke] omega_fill[bf16]: kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
          f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}); no library call makes this Ω",
          flush=True)
    return row


def seeded_bf16_cases(x, a, seed, kt, omega):
    """The three seeded bf16 forms on x (n, d) and, for the power form,
    A = a (n, da), B = x, each against Ω(seed): per form (seeded call,
    its materialized form on ``omega`` — the card's own bf16 Ω — the plain
    product on ``omega``, the K of each output, the staged call or None),
    each call returning a tuple."""
    from repro_torch.kernels import (power_project_accumulate, power_project_accumulate_seeded,
                                     proj_stage, proj_stage_seeded, projgram, projgram_seeded,
                                     ref)

    n, d = x.shape
    return {
        "proj_stage_seeded[bf16]": (lambda: (proj_stage_seeded(x, seed, kt),),
                                    lambda: (proj_stage(x, omega),),
                                    lambda: (ref.proj_stage_ref(x, omega),), (d,), None),
        "projgram_seeded[bf16]": (lambda: projgram_seeded(x, seed, kt, schedule="recompute"),
                                  lambda: projgram(x, omega, schedule="recompute"),
                                  lambda: ref.projgram_ref(x, omega), (d, d + n),
                                  lambda: projgram_seeded(x, seed, kt, schedule="staged")),
        "power_project_accumulate_seeded[bf16]": (
            lambda: (power_project_accumulate_seeded(a, x, seed, kt, schedule="recompute"),),
            lambda: (power_project_accumulate(a, x, omega, schedule="recompute"),),
            lambda: (ref.power_project_accumulate_ref(a, x, omega),), (d + n,),
            lambda: (power_project_accumulate_seeded(a, x, seed, kt, schedule="staged"),)),
    }


def check_seeded_bf16(x, a, seed, kt, names) -> dict:
    """§D.2-4 for the seeded bf16 forms ``names`` at x (n, d), a (n, da),
    k̃: each form bitwise its materialized form on the card's bf16
    ``dense_omega(seed, d, k̃)`` (seeded ≡ materialized), within 4·√K·u of
    the plain product on that same Ω (``check_form``'s bound, so the
    generator's gap to the plain generator is not in it), two launches
    bitwise; the fused forms also recompute ≡ staged, and the power form's
    ``out=acc`` ≡ acc + ΔY under both schedules.  Returns each form's max
    abs error and its cases."""
    import torch

    from repro_torch.kernels import power_project_accumulate_seeded, rand

    n, d = x.shape
    omega = rand.dense_omega(seed, d, kt, torch.bfloat16, device=x.device)
    cases = seeded_bf16_cases(x, a, seed, kt, omega)
    print(f"[smoke] seeded bf16 forms at (n, d, k̃, da) = {(n, d, kt, a.shape[1])}", flush=True)
    errs = {}
    for name in names:
        call, mat, plain, Ks, staged = cases[name]
        errs[name] = check_form(name, call, plain, Ks, mat,
                                "its materialized form on the card's bf16 Ω")
        if staged is not None:
            same = all(torch.equal(r, s) for r, s in zip(call(), staged()))
            print(f"[smoke] {name}: recompute == staged bitwise: {same}", flush=True)
            if not same:
                raise AssertionError(f"{name}: recompute is not its staged pair bitwise")
    if "power_project_accumulate_seeded[bf16]" in names:
        g = torch.Generator(device=x.device)
        g.manual_seed(SEED + 31)
        acc0 = torch.randn((a.shape[1], kt), generator=g, device=x.device)
        ok = []
        for sched in ("recompute", "staged"):
            got = power_project_accumulate_seeded(a, x, seed, kt, schedule=sched,
                                                  out=acc0.clone())
            ok.append(torch.equal(got, acc0 + power_project_accumulate_seeded(
                a, x, seed, kt, schedule="recompute")))
        print(f"[smoke] power_project_accumulate_seeded[bf16](out=acc) == acc + ΔY bitwise "
              f"(recompute, staged): {ok}", flush=True)
        if not all(ok):
            raise AssertionError("power_project_accumulate_seeded[bf16](out=) is not acc + ΔY")
    return errs, cases, omega


def phase_seeded_bf16(dev, a16, b16) -> dict:
    """The three seeded bf16 forms (§D.2-4) at ragged shapes, at shapes of
    several slabs and buckets, at the smoke fit's pass-0 shape, then at the
    main path's shapes with times: ``proj_stage_seeded[bf16]`` at 8192 ×
    2^19 → 2060 (the p = 2000 power pass stages), the fused forms at
    8192 × 2^19 → 970 with the narrow A (8192 × 1024), as their f32 and
    unseeded bf16 rows.  ``a16``, ``b16``: one Europarl chunk in bf16."""
    import torch

    from repro_torch.kernels import rand, ref

    bf16 = torch.bfloat16
    seed = rand.omega_seeds(SEED)[1]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 37)
    all3 = ("proj_stage_seeded[bf16]", "projgram_seeded[bf16]",
            "power_project_accumulate_seeded[bf16]")
    # (n, d, k̃, da): three slabs, the last ragged (9001 = 2·4096 + 809), k̃ ragged;
    # a last slab of 4 rows and k̃ = 3; the smoke fit's chunk (one slab, k̃ = 32);
    # 2 C buckets (k̃ = 1100) and 23 ΔY buckets
    for n, d, kt, da in [(333, 9001, 67, 517), (130, 4100, 3, 301), (512, 192, 32, 256),
                         (333, 9001, 1100, 20000)]:
        x, a = (torch.randn(s, generator=g, device=dev).to(bf16) for s in ((n, d), (n, da)))
        check_seeded_bf16(x, a, seed, kt, all3)
        del x, a
    torch.cuda.empty_cache()

    n, d = b16.shape
    an = a16[:, :DA_NARROW].contiguous()
    rows = {}
    for kt, names in [(2060, all3[:1]), (KT_910, all3[1:])]:
        errs, cases, omega = check_seeded_bf16(b16, an, seed, kt, names)
        torch.cuda.empty_cache()
        int_ops, gram = OMEGA_INT_OPS * d * kt, n * kt * (kt + 1)
        proj = 2 * n * d * kt
        plains = {
            "proj_stage_seeded[bf16]": (lambda: ref.proj_stage_seeded_ref(b16, seed, kt),
                                        lambda: torch.matmul(b16, omega), 0,
                                        2 * n * d + 4 * n * kt),
            "projgram_seeded[bf16]": (lambda: ref.projgram_seeded_ref(b16, seed, kt), None,
                                      gram, 2 * n * d + 4 * (n * kt + kt * (kt + 1) // 2)),
            "power_project_accumulate_seeded[bf16]": (
                lambda: ref.power_project_accumulate_seeded_ref(an, b16, seed, kt),
                lambda: torch.linalg.multi_dot([an.T, b16, omega]), 2 * n * DA_NARROW * kt,
                2 * (n * d + n * DA_NARROW) + 4 * DA_NARROW * kt),
        }
        for name in names:
            call, _, _, _, staged = cases[name]
            plain, lib, flops, nbytes = plains[name]
            t = {"ms": time_ms(call, 3), "plain_ms": time_ms(plain, 3),
                 "library_ms": None if lib is None else time_ms(lib, 3)}
            if staged is not None:
                t["staged_ms"] = time_ms(staged, 3)
            rows[name] = dict(max_abs_err=errs[name],
                              **bound(flops, nbytes, int_ops, tc_flops=proj), **t)
            lib_txt = ("none" if lib is None
                       else f"{t['library_ms']:.3f} ms (bf16, on Ω made before)")
            staged_txt = f", staged pair {t['staged_ms']:.3f} ms" if staged is not None else ""
            # the tensor cores and the CUDA cores' int32 / f32 work are separate
            # units: if they overlap fully, the least time is the larger of the two
            overlap_ms = 1e3 * max(proj / BF16_PEAK_FLOPS,
                                   flops / F32_PEAK_FLOPS + int_ops / INT32_PEAK_OPS,
                                   nbytes / HBM_BYTES_PER_S)
            print(f"[smoke] {name} at {(n, d)} → {kt}: kernel {t['ms']:.3f} ms{staged_txt}, "
                  f"plain {t['plain_ms']:.3f} ms (plain generator included), library {lib_txt}, "
                  f"bound {rows[name]['bound_ms']:.3f} ms ({rows[name]['bound_by']}, "
                  f"tensor-core and CUDA-core times added), {overlap_ms:.3f} ms if the two "
                  f"overlap; {(proj + flops) / t['ms'] / 1e9:.1f} TFLOP/s", flush=True)
            torch.cuda.empty_cache()
        del cases, omega
    return rows


def bf16_fit_pair(argv, label, want_seeded, want_oracle, schedules):
    """``--omega seeded`` and ``--omega seeded-materialized`` of one bf16
    stream fit: launches and schedules as predicted, and ρ, Xa, Xb bitwise
    equal.  Returns (seeded launches, oracle launches, seeded ρ)."""
    import torch

    rep_s, launches_s, peak_s, _ = run_fit(argv + ["--omega", "seeded"], f"{label} seeded")
    fit_checks(rep_s, f"{label} seeded", want_seeded, schedules)
    seeded = [t.cpu() for t in rep_s.result[:3]]
    del rep_s
    rep_m, launches_m, peak_m, _ = run_fit(argv + ["--omega", "seeded-materialized"],
                                           f"{label} seeded-materialized")
    fit_checks(rep_m, f"{label} seeded-materialized", want_oracle, schedules)
    oracle = [t.cpu() for t in rep_m.result[:3]]
    del rep_m
    same = [torch.equal(x, y) for x, y in zip(seeded, oracle)]
    print(f"[smoke] {label}: seeded vs seeded-materialized bitwise (Xa, Xb, rho): {same}; "
          f"sum rho {float(seeded[2].double().sum()):.6f}; peak {peak_s:.2f} / {peak_m:.2f} GB",
          flush=True)
    if not all(same) or not rho_ok(seeded[2]):
        raise AssertionError(f"{label}: seeded is not bitwise seeded-materialized, or rho "
                             "leaves [0, 1]")
    return launches_s, launches_m, seeded[2].double()


# each bf16 stream fit of phase_stream_bf16 → the f32 fit of this script on
# the same data and Ω
F32_TWIN = {
    "stream bf16 seeded": "omega=seeded",
    "stream bf16 seeded-materialized": "omega=seeded-materialized",
    "stream bf16 kernels engine": "kernels engine",
    "stream bf16 torch engine": "torch engine",
    "stream bf16 p=910 q=0 seeded": "p=910 q=0 seeded",
    "stream bf16 p=910 q=0 seeded-materialized": "p=910 q=0 seeded-materialized",
    "stream bf16 smoke seeded": "stream f32 smoke seeded",
    "stream bf16 smoke seeded-materialized": "stream f32 smoke seeded",
    "stream bf16 smoke kernels engine": "stream f32 smoke kernels engine",
    "stream bf16 smoke torch": "stream f32 smoke torch",
}


def print_sum_rho_gaps() -> None:
    """Each bf16 stream fit's Σρ beside its f32 twin's, and |Σρ_bf16 −
    Σρ_f32|."""
    for bf, f in F32_TWIN.items():
        if f not in SUM_RHO:
            print(f"[smoke] {bf}: sum rho {SUM_RHO[bf]:.6f} (no f32 run to compare)", flush=True)
            continue
        print(f"[smoke] {bf}: sum rho {SUM_RHO[bf]:.6f}, f32 ({f}) {SUM_RHO[f]:.6f}, "
              f"|Σρ_bf16 − Σρ_f32| = {abs(SUM_RHO[bf] - SUM_RHO[f]):.3e}", flush=True)


def phase_stream_bf16(dev) -> dict:
    """The stream fit at ``--compute-dtype bfloat16`` (``RCCAConfig(dtype=
    bfloat16)``): at Europarl width (p = 2000, both passes staged, n cut
    to N_CHUNKS) ``--omega seeded`` bitwise ``seeded-materialized``, and
    the materialized kernels engine against the torch engine (|Δρ| ≤ 1e-3);
    ``--p 910 --q 0`` seeded bitwise its oracle (the final pass
    recomputes); then the smoke width, centered, where both passes
    recompute: seeded bitwise its oracle, kernels against torch.  Each fit
    prints its launches by name, schedules, pass times, peak memory and
    Σρ beside the f32 fit's.  Returns each seeded bf16 form's and the bf16
    generator's launches in the run that drives it."""
    import torch

    bf16 = ["--compute-dtype", "bfloat16"]
    argv = ["--device", dev.type, "--n-chunks", str(N_CHUNKS), "--seed", str(SEED)] + bf16
    print(f"[smoke] stream bf16: Europarl width, n cut to {N_CHUNKS} chunks of 8192 rows",
          flush=True)
    nc = N_CHUNKS
    power = {"proj_stage[bf16]": 2 * nc, "powerpass_sweep[bf16,f32]": 2 * nc}
    final = {"proj_stage[bf16]": 2 * nc, "gram_sweep": 2 * nc, "matmul_tn": nc}
    launches_s, launches_m, _ = bf16_fit_pair(
        argv, "stream bf16", [{"proj_stage_seeded[bf16]": 2 * nc,
                               "powerpass_sweep[bf16,f32]": 2 * nc}, final],
        [{"omega_fill[bf16]": 2, **power}, final], ["staged", "staged"])
    rep_k, _, peak_k, _ = run_fit(argv, "stream bf16 kernels engine")
    fit_checks(rep_k, "stream bf16 kernels engine", [power, final], ["staged", "staged"])
    rho_k = rep_k.result.rho.double().cpu()
    finite = all(bool(torch.isfinite(t).all()) for t in rep_k.result[:3])
    del rep_k
    rep_t, launches_t, peak_t, _ = run_fit(argv + ["--engine", "torch"],
                                           "stream bf16 torch engine")
    rho_t = rep_t.result.rho.double().cpu()
    del rep_t
    gap = float((rho_k - rho_t).abs().max())
    print(f"[smoke] stream bf16: max |rho_kernels - rho_torch| = {gap:.3e} (limit 1e-3); "
          f"sum rho {float(rho_k.sum()):.6f} vs {float(rho_t.sum()):.6f}; peak {peak_k:.2f} / "
          f"{peak_t:.2f} GB", flush=True)
    if launches_t or not finite or not gap <= 1e-3 or not rho_ok(rho_k):
        raise AssertionError("stream bf16: the engines disagree, or the fit is not finite "
                             "in [0, 1]")

    q0 = ["--device", dev.type, "--n-chunks", str(N_CHUNKS), "--seed", str(SEED), "--p", "910",
          "--q", "0"] + bf16
    print("[smoke] stream bf16: p = 910, q = 0 (the final pass recomputes)", flush=True)
    final_910 = {"projgram_seeded[bf16]": 2 * nc, "matmul_tn": nc}
    launches_910, _, _ = bf16_fit_pair(
        q0, "stream bf16 p=910 q=0", [final_910],
        [{"omega_fill[bf16]": 2, "projgram[bf16]": 2 * nc, "matmul_tn": nc}], ["recompute"])

    smoke = ["--smoke", "--center", "--device", dev.type, "--seed", str(SEED)]
    print("[smoke] stream bf16: smoke width, centered (both passes recompute)", flush=True)
    snc = 8
    sfinal = {"projgram[bf16]": 2 * snc, "matmul_tn": snc}
    # centering needs Ω at pass 0's boundary: one omega_fill[bf16] per view
    launches_smoke, _, _ = bf16_fit_pair(
        smoke + bf16, "stream bf16 smoke",
        [{"power_project_accumulate_seeded[bf16]": 2 * snc}, {"omega_fill[bf16]": 2, **sfinal}],
        [{"omega_fill[bf16]": 2, "power_project_accumulate[bf16]": 2 * snc}, sfinal],
        ["recompute", "recompute"])
    rep_k, _, _, _ = run_fit(smoke + bf16, "stream bf16 smoke kernels engine")
    fit_checks(rep_k, "stream bf16 smoke kernels engine",
               [{"power_project_accumulate[bf16]": 2 * snc}, sfinal], ["recompute", "recompute"])
    rep_t, _, _, _ = run_fit(smoke + bf16 + ["--engine", "torch"], "stream bf16 smoke torch")
    gap = float((rep_k.result.rho.double() - rep_t.result.rho.double()).abs().max())
    print(f"[smoke] stream bf16 smoke: max |rho_kernels - rho_torch| = {gap:.3e} (limit 1e-3)",
          flush=True)
    if not gap <= 1e-3 or not rho_ok(rep_k.result.rho):
        raise AssertionError("stream bf16 smoke: the engines disagree, or rho leaves [0, 1]")
    for label, extra in [("seeded", ["--omega", "seeded"]), ("kernels engine", []),
                         ("torch", ["--engine", "torch"])]:  # the f32 twins at the smoke width
        run_fit(smoke + extra, f"stream f32 smoke {label}")
    print_sum_rho_gaps()
    return {"proj_stage_seeded[bf16]": launches_s["proj_stage_seeded[bf16]"],
            "omega_fill[bf16]": launches_m["omega_fill[bf16]"],
            "projgram_seeded[bf16]": launches_910["projgram_seeded[bf16]"],
            "power_project_accumulate_seeded[bf16]":
                launches_smoke["power_project_accumulate_seeded[bf16]"]}


def ring_spills() -> None:
    """ptxas's registers and spills for each instance of the staged f32
    kernel (``gemm_ring.cuh`` ``ring_kernel``: NN or TN, its mode, its A
    type and its tile), of the bf16 wgmma tile (``gemm_bf16.cuh``
    ``wgmma_kernel``: NN or TN and its mode) and of the fused kernels
    (``recompute_f32_kernel``: phase 1's mode, phase 2's;
    ``recompute_bf16_kernel``: phase 1's mode, phase 2's, A's type; and
    ``fused_tile``, the phase tile they call), from the build's ``-Xptxas
    -v`` output.  A fused instance or phase tile that spills fails the
    run, and so does any warning of ptxas that names wgmma (it
    serializes the products when it cannot keep them in flight)."""
    import re

    from repro_torch.kernels import build

    modes = {"0": "overwrite", "1": "accumulate", "2": "continue"}

    def name_of(fn):
        k = re.search(r"ring_kernelILb(\d)ELi(\d)E(\w)NS_4TileILi(\d+)ELi(\d+)ELi(\d)E", fn)
        if k:
            return (f"{'TN' if k.group(1) == '1' else 'NN'} {modes[k.group(2)]} "
                    f"{'bf16' if k.group(3) == 't' else 'f32'} A, {k.group(4)}×{k.group(5)}")
        k = re.search(r"wgmma_kernelILb(\d)ELi(\d)E", fn)
        if k:
            return f"wgmma tile {'TN' if k.group(1) == '1' else 'NN'} {modes[k.group(2)]}"
        k = re.search(r"recompute_bf16_kernelILi(\d)ELi(\d)E(\w)", fn)
        if k:
            return (f"fused bf16 phase 1 {modes[k.group(1)]}, phase 2 {modes[k.group(2)]}, "
                    f"{'bf16' if k.group(3) == 't' else 'f32'} A2")
        k = re.search(r"recompute_f32_kernelILi(\d)ELi(\d)E", fn)
        if k:
            return f"fused f32 phase 1 {modes[k.group(1)]}, phase 2 {modes[k.group(2)]}"
        k = re.search(r"fused_tileILb(\d)ELi(\d)E(\w)", fn)
        if k:
            return (f"fused phase tile {'TN' if k.group(1) == '1' else 'NN'} {modes[k.group(2)]} "
                    f"{'bf16' if k.group(3) == 't' else 'f32'} A")
        return None

    serialized, spilled, fused = [], [], set()
    for lib, entry in build.BUILD_LOG.items():
        fn, rows = None, []
        for line in entry["log"].splitlines():
            # C7514 (and its kin) come as info or as a warning, by toolkit
            if "C7514" in line or ("wgmma" in line and ("arning" in line or "serialized" in line)):
                serialized.append(line.strip())
            m = re.search(r"Function properties for (\S+)", line) or re.search(
                r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
                continue
            name = name_of(fn) if fn is not None else None
            if name is None:
                continue
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if not (spill or regs):
                continue
            rows.append(f"{name}: " + (f"{spill.group(1)} B spill stores, {spill.group(2)} B "
                                       f"spill loads" if spill else f"{regs.group(1)} registers"))
            if name.startswith("fused"):
                if not name.startswith("fused phase"):
                    fused.add(name)
                if spill and (int(spill.group(1)) or int(spill.group(2))):
                    spilled.append(rows[-1])
        for row in rows:
            print(f"[smoke] ptxas {lib}: {row}", flush=True)
    for line in serialized:
        print(f"[smoke] ptxas: {line}", flush=True)
    if serialized:
        raise AssertionError("ptxas serialized the wgmma products of a bf16 kernel")
    if spilled:
        raise AssertionError(f"fused kernel instances spill: {spilled}")
    if build.BUILD_LOG.get("recompute_f32") and len(fused) != 12:
        raise AssertionError(f"ptxas reported {len(fused)} fused kernels, not 4 f32 + 8 bf16")


def tile_occupancy() -> None:
    """Each f32 tile's blocks per SM on this card (the occupancy API) must be
    the plan's, staged and in the fused f32 kernel on ``plan.FUSED_F32_TILE``
    (whose cooperative grid is sized from it), or the waves the rule models
    are not the card's; so
    must the bf16 wgmma tile's, staged and fused, at its dynamic shared
    memory."""
    from repro_torch.kernels import build, plan

    for tile, (bm, bn, threads, per_sm) in enumerate(plan.F32_TILES):
        got = [build.blocks_per_sm(tn, tile) for tn in (False, True)]
        print(f"[smoke] f32 tile {tile} ({bm}×{bn}, {threads} threads): blocks per SM NN/TN "
              f"{got}, plan {per_sm}; {plan.ring_smem(tile)} B of shared memory asked",
              flush=True)
        if got != [per_sm, per_sm]:
            raise AssertionError(f"f32 tile {tile}: {got} blocks per SM, the plan has {per_sm}")
        if tile == plan.FUSED_F32_TILE:
            fused = build.fused_f32_blocks_per_sm()
            print(f"[smoke] fused f32 kernel (tile {tile}): blocks per SM {fused}, plan "
                  f"{per_sm}", flush=True)
            if fused != per_sm:
                raise AssertionError(f"fused f32 kernel: {fused} blocks per SM, the plan has "
                                     f"{per_sm}")
    got = build.bf16_blocks_per_sm()
    print(f"[smoke] bf16 wgmma tile (128×128, {plan.BF16_THREADS} threads, "
          f"{plan.SMEM_BYTES_BF16} B of dynamic shared memory): blocks per SM {got}, plan "
          f"{plan.BF16_BLOCKS_PER_SM}", flush=True)
    if set(got.values()) != {plan.BF16_BLOCKS_PER_SM}:
        raise AssertionError(f"bf16 tile: {got} blocks per SM, the plan has "
                             f"{plan.BF16_BLOCKS_PER_SM}")


def tile_line(name: str, M: int, N: int) -> str:
    """The tile ``plan.f32_tile`` picks for an M × N output, its tiles and waves."""
    from repro_torch.kernels import plan

    tile = plan.f32_tile(M, N)
    bm, bn, _, per_sm = plan.F32_TILES[tile]
    tiles, waves = plan.tile_waves(M, N, tile)
    return (f"[smoke] {name} output {M}×{N}: tile {bm}×{bn} ({per_sm} per SM), {tiles} tiles, "
            f"{waves} waves of {per_sm * plan.SMS}, {100 * plan.idle_share(M, N, tile):.1f} % "
            "of the slots idle")


def sass_hmma() -> None:
    """HGMMA (wgmma) and HMMA (mma.sync) instructions per kernel of the
    three libraries, from ``cuobjdump -sass``: every kernel on the bf16
    wgmma tile, staged (``wgmma_kernel``) or fused
    (``recompute_bf16_kernel``), must issue HGMMA; the old tile kept as a
    witness (``gemm_bf16_mma``) HMMA and no HGMMA; the f32 kernels (CUDA
    cores, no TF32) and the generator neither."""
    import re

    from repro_torch.kernels import build

    tool = Path(build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        print("[smoke] cuobjdump not found: SASS not checked", flush=True)
        return
    for lib in ("gemm_f32", "gemm_bf16", "recompute_f32"):
        sass = subprocess.run([str(tool), "-sass", str(build._target(lib))], capture_output=True,
                              text=True, check=True).stdout
        counts, ops, fn = {}, set(), None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = {"HGMMA": 0, "HMMA": 0}
            elif fn is not None:
                for op in ("HGMMA", "HMMA"):
                    if re.search(rf"\b{op}\.", line):
                        counts[fn][op] += 1
                        ops.update(re.findall(rf"\b{op}\.\S+", line))
        print(f"[smoke] SASS HGMMA / HMMA per kernel, {lib}: "
              f"{ {fn: (c['HGMMA'], c['HMMA']) for fn, c in counts.items()} }; "
              f"opcodes {sorted(ops)}", flush=True)
        for fn, c in counts.items():
            if "wgmma_kernel" in fn or "recompute_bf16_kernel" in fn:
                ok = c["HGMMA"] > 0
            elif "gemm_bf16_mma" in fn:
                ok = c["HMMA"] > 0 and c["HGMMA"] == 0
            else:
                ok = c["HGMMA"] == 0 and c["HMMA"] == 0
            if not ok:
                raise AssertionError(f"{fn}: {c['HGMMA']} HGMMA and {c['HMMA']} HMMA "
                                     "instructions")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs one card",
              file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is not at {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    card = card_line()
    print(f"[smoke] card: {card}", flush=True)
    print(f"[smoke] host MemTotal: {mem_total()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build()
    print(f"[smoke] build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, entry in build.BUILD_LOG.items():
        print(f"[smoke] nvcc {build.LIBRARIES[name].name} ({entry['seconds']:.2f} s):\n"
              f"{entry['log']}", flush=True)
    ring_spills()
    sass_hmma()
    tile_occupancy()

    from repro_torch.configs.europarl_cca import config
    from repro_torch.data import DevicePlantedChunks

    wl = config()
    a, b = DevicePlantedChunks(wl.chunk, wl.da, wl.db, rank=2 * wl.rcca.k, seed=SEED,
                               chunk=wl.chunk, device=dev).get_chunk(0)
    rows = phase_kernels(dev, a, b)
    torch.cuda.empty_cache()
    rows["omega_fill"] = phase_omega(dev)
    torch.cuda.empty_cache()
    rows["proj_stage_seeded"] = phase_seeded(dev, b)
    torch.cuda.empty_cache()
    rows.update(phase_recompute(dev, a, b))
    torch.cuda.empty_cache()
    rows["matmul_nn"] = phase_matmul_nn(dev, a)
    a16 = a.to(torch.bfloat16)
    del a
    b16 = b.to(torch.bfloat16)
    del b
    torch.cuda.empty_cache()
    rows.update(phase_bf16_kernels(dev, a16, b16))
    torch.cuda.empty_cache()
    rows["omega_fill[bf16]"] = phase_omega_bf16(dev)
    torch.cuda.empty_cache()
    rows.update(phase_seeded_bf16(dev, a16, b16))
    del a16, b16
    torch.cuda.empty_cache()
    launches = phase_smoke_fits(dev)
    launches.update(phase_fit(dev))
    launches.update(phase_fit_910(dev))
    launches.update(phase_stream_bf16(dev))
    dist_launched, rho_f32 = phase_dist(dev)
    launches.update(dist_launched)
    launches.update(phase_dist_bf16(dev, rho_f32))

    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches.get(name, 0), **row}
               for name, row in rows.items()]
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was not launched on the main path")
    print(f"[smoke] total wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
