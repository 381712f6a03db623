#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout, one H100

Phases, each of which fails the run by raising:

1. device — needs CUDA; prints the card's name and power limit and the
   host's memory (the merge stack's closed groups live there); turns
   TF32 off for every f32 product;
2. build — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (four ``nvcc`` started together), prints ptxas's registers and spills
   for every instance of the staged f32 kernel (``gemm_ring.cuh``), of the
   bf16 wgmma tile (``gemm_bf16.cuh``), of the fused kernels, f32 (both
   phases on the ring's 128 × 128 tile, each mode pair) and bf16, and of
   the serving form's two kernels (``gemm_rows.cu``), fails if a
   fused instance spills or if ptxas reports that it serialized the wgmma
   products of a bf16 kernel; counts the HGMMA and HMMA instructions of
   each kernel in ``cuobjdump -sass``: every kernel on the wgmma tile,
   staged or fused, must issue HGMMA, the old mma.sync tile kept as a
   witness HMMA only, the f32 kernels and the generator neither;
2a. analysis (right after the build) — the static-analysis gate in
   process (``python -m repro_torch.analysis``'s ``main``): the
   architecture lint over ``src/repro_torch`` clean, the kernel contracts
   (RCCA101-106, RCCA108) of every registered form at the main path's
   shapes and, run on the card, at small probes, with the occupancy API's
   blocks per SM of each f32 tile, staged and (128 × 128) in the fused
   f32 kernel, of the wgmma tile and the fused bf16 kernels at their
   dynamic shared memory, and of the serving form's segment tiles equal
   to the plan's (``plan.F32_TILES``, ``plan.BF16_BLOCKS_PER_SM``,
   ``plan.ROWS_TILES``), so the printed waves and cooperative grids are
   the card's; the protocol explorer clean over its 5 crash scenarios and
   42 interleavings; it must print ``ANALYZE: OK``.  Its sanitizer half
   runs inside phase 15;
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
   stack reached while it kept closed groups on the card), traced
   (``--trace build/trace_fit``: its ρ/Xa digests unchanged, coverage
   ≥ 0.95, ``kernel_cost`` calls per entry point equal to the launch
   counters, ``device_s`` on every chunk and io_wait span, the modelled
   fold rate under the f32 peak, each pass's chunk and io_wait seconds on
   the card beside its wall and the predictions, ``export-trace`` JSON
   with one X event per span; no later fit may write a trace), then
   ``engine="torch"`` on the same data and Ω (their ρ must agree), then
   ``--omega seeded`` and ``--omega seeded-materialized`` at
   ``PAIR_CHUNKS`` = 2 (their contract holds at any depth), whose ρ and
   X must be bitwise equal, at 4 / 5 launches per
   power / final chunk (both passes staged), the seeded one holding less
   device memory; then the paper's other oversampling, ``--p 910``
   (k̃ = 970), where the final pass recomputes: kernels engine (2
   ``projgram`` + 1 ``matmul_tn`` per final chunk, no ``gram_sweep``)
   against the torch engine (``P910_CHUNKS`` = 2), and ``--q 0 --omega
   seeded`` bitwise ``--omega seeded-materialized`` (``PAIR_CHUNKS``);
8. matmul_nn — ``matmul_nn`` (the port of ``_mm_nn_kernel``) at one
   microbatch of one model shard at Europarl width (4096 × 2^18 · 2^18 ×
   2060) and at 333 × 9001 → 67: within 4·√K·u of its plain version,
   bitwise repeatable, bitwise ``proj_stage`` on the same operands, with
   times;
9. dist — the resident sharded fit (``cca_fit.fit_dist_runs``, the
   ``--mode dist`` path), as jobs of rank processes that each run a list
   of fits (one spawn and rendezvous a job, the rows and Ω made once per
   mesh): at Europarl width (one 8192-row chunk, p = 2000, microbatch
   4096) two ranks on a 1 × 1 × 2 mesh share the card over gloo, once per
   collective (``unfused``, ``fused``, ``fused-int8ef``) and once on the
   torch engine, then the same at bf16 (phase 11's): unfused ≡ fused
   bitwise in ρ and in each rank's Xa and Xb, the launches per rank and
   pass of the ``ops`` table, |Δρ| ≤ 1e-3 against the torch engine and
   against stream mode on the same chunk and Ω, int8ef within rtol 0.05 /
   atol 0.02 of fused, each rank's peak memory printed; then one job at the
   smoke width, centered, on four ranks (1 × 2 × 2, where the row and the
   column sums are both real; each collective in f32 and bf16, then
   1 × 4 × 1 in bf16), where one more f32 fit reads each rank's rows from
   a view store of the same rows (``--mode dist --data``) and must match
   the in-memory fused fit within tests/test_torch_dist.py's tolerances.
   Each fit resets its ranks' launch counters, and each rank reports its
   own;
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
11. dist bf16 — the sharded fit at ``compute_dtype=bfloat16``, from phase
    9's jobs: at Europarl width on 1 × 1 × 2 (``unfused`` ≡ ``fused``
    bitwise per rank, the bf16 launches per rank and pass, |Δρ| ≤ 1e-3
    against the torch engine, |ρ_bf16 − ρ_f32| printed) and on 1 × 1 × 1
    (a job of its own; the chunk updates: ``proj_stage[bf16]`` and
    ``powerpass_sweep[bf16,f32]``; ρ within 1e-3 of 1 × 1 × 2); then the
    smoke width, centered, on four ranks: 1 × 2 × 2 under all three
    collectives and 1 × 4 × 1, where both passes recompute
    (``power_project_accumulate[bf16]``, ``projgram[bf16]``);
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
    at Europarl width (p = 2000, both passes staged) ``--omega seeded``
    bitwise ``seeded-materialized`` (``PAIR_CHUNKS``), the kernels engine
    against the torch engine (``BF16_PAIR_CHUNKS`` = 2, |Δρ| ≤ 1e-3);
    ``--p 910 --q 0``
    seeded bitwise its oracle (``PAIR_CHUNKS``); the smoke width, centered (both
    passes recompute):
    seeded bitwise its oracle, kernels against torch.  Each fit prints its
    launches by name, schedules, pass times, peak memory and Σρ beside
    the f32 fit's;
14. store — the out-of-core main path (``phase_store``): store-backed
    fits bitwise the in-memory fits at the smoke and Europarl widths,
    prefetch 0 ≡ 2 ≡ auto, kill → resume bitwise, IO per pass, cursors;
15. cluster (inside phase 14, on its stores) — the Cluster, Sharded and
    Hybrid topologies (``phase_cluster``): at the smoke width the streaming
    ``Sharded`` fit over two slots on the card (two streams), bitwise the
    Local fit with its launches (``sharded_smoke``), then on threads two
    workers, combine 1 with one worker killed and re-dispatched and combine
    2, and ``Hybrid(2, 2)`` with every slot on the card, clean and with a
    worker killed after its first group (its other group re-dispatched):
    each bitwise the Local fit, the clean ones with its launches summed
    over the workers; at Europarl width the Local store fit with ``--omega
    seeded``, then, alone on the card, the same store's ``Sharded`` fit
    over two slots (``sharded_europarl``: bitwise it, its launches, pass
    times, peak memory and each batch's slot device seconds), then the
    cluster fit of the same store in a child process (two workers sharing
    the card), bitwise it, its launches summed over the workers the Local
    fit's, every worker on ``cuda:0``, each pass's publish, barrier, merge
    and boundary seconds, its bytes and each worker's peak memory; the
    child runs under ``RCCA_TRACE`` (its workers inherit it): no protocol
    violation, every process a role and coverage ≥ 0.95, the
    coordinator's publish, barrier and merge spans within 10 ms of its
    diagnostics, the workers' ``kernel_cost`` calls their launches.  The
    smoke-width fits run under the determinism sanitizer (``RCCA_SANITIZE``
    in their own thread's context, ``sanitize.override``; the Europarl
    fits beside them are not sanitized): the Sharded, the combine-1
    cluster and both Hybrid fits' traces equal the Local fit's record for
    record (the site aside), the combine-2 fit's at every ``pass_end``
    and its workers' group fingerprints the Local fit's; then one more
    smoke fit of the same chunks with one bit of chunk 5 flipped, whose
    first divergence from the Local trace must be pass 0's merge group 2
    (``sanitize_smoke``);
16. serve (inside phases 14 and 15, on their store) — the incremental
    fit and the serving tier: at the smoke width, in a child process
    beside phase 15's cluster child, ``cca_serve --smoke`` under both
    engines (the kernels one with ``--trace``: its refit, index, batch,
    swap, registry and drift spans and counters) and the delta-refit
    contracts, the Sharded ``fit_with_state`` → ``delta_refit`` pair
    among them (``serve_child``); at Europarl
    width phase 14's store is written in two steps (its first 8 chunks
    while the kernels build) and ``fit_with_state`` (seeded) runs on the
    first 8 chunks; its FitState is saved beside phase 14's fits, and
    the exact ``delta_refit`` over the 9 chunks runs before phase 14's
    kill test; v1 and v2 are published beside phase 15's Local seeded
    fit, which the delta refit must equal bitwise, with one chunk's
    pass-0 launches plus its pass-1 launches; before phase 15's cluster
    child (the run's disk holds one of the two at a time) both load,
    hashes verified, the corpus index and the drift monitor run and the
    ``BatchedProjector`` serves concurrent clients across the v1 → v2
    swap, each response bitwise ``project_rows`` (the port's serving
    kernel, ``gemm_rows.cu``) of its row alone under its
    stamped version, and the index's first rows bitwise a projector's
    responses for them (``phase_serve``); then ``project_rows`` itself:
    a 512-row launch's rows ≡ a 32-row launch's ≡ each alone, the index's
    256-row tail ≡ its rows alone, bitwise, and at buckets 1, 32 and 512
    within 4·√K·u of its plain version, with times beside the plain
    version, one ``torch.matmul`` and the bound (``serve_kernel``);
17. horst kernels (after phase 8, on phase 3's rows) — the paper's Horst
    baseline streams products of width k = 60: ``proj_stage`` (8192 × 2^19
    → 60), ``powerpass_sweep(out=)`` (2^19 × 60 over 8192 rows) and
    ``power_project_accumulate(a, a, V, out=)`` on the schedule the rule
    resolves (staged there; bitwise its staged pair), each within 4·√K·u
    of its plain version and bitwise repeatable, timed beside the plain
    version, one PyTorch call (yardstick only) and the bound, with the
    tile ``plan.f32_tile`` picks, its tile count and waves
    (``phase_horst_kernels``);
18. horst (after phase 7) — Horst+rcca at Europarl width: streaming Horst
    (``repro_torch.core.horst``) over the first ``HORST_CHUNKS`` = 4 of
    phase 7's chunks (the same planted rows; d = 2^19 and k = 60 uncut),
    warm from phase 7's kernels-engine ``Xa``, ``Xb`` (one iteration of 2
    CG steps) on the kernels and the torch engine, and cold from a seeded
    Gaussian (one iteration of 3 CG steps: at least the warm run's
    passes), λ phase 7's scaled to the rows Horst sees; each run's pass
    count the reference's formula, its launches passes × chunks × the
    ``ops`` table, ρ in [0, 1]; |Δρ| ≤ 1e-3 between the engines and the
    warm Σρ above the cold one (Table 2b's direction); each pass's seconds
    and the peak device memory printed (``phase_horst``);
19. horst smoke — dense ``horst_cca`` (Cholesky and CG) and streaming
    Horst at the smoke width on the card against the port's CPU run on
    the same rows and start (ρ within 1e-4, sign-aligned X within 1e-3
    relative), with their launches, then ``examples/europarl_cca_torch.py``
    at its defaults (4,096 slots: hashing, the streamed fit, Horst+rcca),
    which must end in ``OK`` (``phase_horst_smoke``);
20. zoo (last) — the model zoo's serving path and activation harvesting
    (``phase_zoo``): (a) the four ported archs' smoke configs in f32, the
    same weights on the CPU and the card, ``forward_hidden``, prefill and 4
    decode steps within 1e-5 of the CPU (gemma3's 40-token prompt past its
    window of 16), prefill + decode against teacher forcing on the card
    within 5e-4; (b) granite-3-2b at full width (d = 2048, 40 layers, GQA
    32/8, vocab 49,155): in f32 prefill + one decode step against the
    teacher-forced logits within 4·√(L·K)·u, then ``repro_torch.launch.serve
    --arch granite-3-2b --batch 8 --prompt-len 512 --gen 32`` in bf16 with
    its prefill ms, decode ms per step, tokens/s and peak memory; (c)
    granite-3-2b (da = 2048) against gemma3-1b (db = 1152), both bf16 at
    full width, harvested over 8 token batches of 8 × 512 (8 chunks of
    4,096 f32 rows), ``RCCAConfig(k=60, p=196, q=1, ν=0.01, center=True)``
    on the kernels engine, the torch engine on the same Ω (|Δρ| ≤ 1e-3)
    and the shuffled-alignment control (aligned Σρ above it by more than
    0.5), launches against the ``ops`` table and schedules against the
    rule, seconds per pass and model seconds per chunk, then each kernel
    the fit launched at one chunk's shape against its plain version
    (4·√K·u), bitwise repeatable (recompute ≡ staged), timed beside its
    plain version, one PyTorch call and the bound (``zoo_harvest``); (d)
    ``examples/activation_cca_torch.py`` at its defaults ends in ``OK``.

Every fit resets the launch counters just before it and reads them just
after, and every kernels-engine stream fit, f32 or bf16, prints the first
16 hex digits of the sha256 of ρ's and of Xa's raw bytes; each group of
phases prints its wall, and the total wall time is printed at the end.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the ``kernels`` JSON, and before that the card's name and power limit.
Without CUDA, or without the repository beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

F32_PEAK_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores (data sheet)
BF16_PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores (data sheet)
# int32 on the CUDA cores: 64 lanes per SM and clock against f32's 128,
# so half the f32 FMA issue rate (33.5e12 FMA/s)
INT32_PEAK_OPS = 16.75e12
HBM_BYTES_PER_S = 3.35e12
U = 2.0 ** -24  # f32 unit roundoff
N_CHUNKS = 16  # two merge groups of 8: the pairwise tree merges once
# the bitwise pairs (seeded ≡ seeded-materialized, f32 and bf16, p = 2000
# and p = 910 q = 0): part of a merge group, where their contract holds as
# at any depth (cut from 16 to 8, to 4, then to 2, for the time limit)
PAIR_CHUNKS = 2
# the p = 910 kernels-against-torch pair: part of one merge group (cut from
# 16 to 8, to 4, then to 2, for the time limit)
P910_CHUNKS = 2
# the bf16 kernels-against-torch pair: part of one merge group, where the
# engines' agreement holds as at any depth (cut from 16 to 4, then to 2, for
# the time limit; the 16-chunk f32 fits keep the tree's merge of full-width
# stats)
BF16_PAIR_CHUNKS = 2
# phase 18's streaming Horst at Europarl width: the first chunks of phase 7's
# rows (depth cut for the time limit; d = 2^19 and k = 60 uncut)
HORST_CHUNKS = 4
# the streaming Sharded topology's slots on the one card: two streams
SHARDED_SLOTS = ("cuda:0", "cuda:0")
# timed runs of a plain version at the main path's shapes (a yardstick, not a
# kernel: cut from 3 for the time limit); see time_plain
PLAIN_REPS = 1
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
# phase 7's traced Europarl fit: its trace directory (emptied after its
# checks; no later fit of this process may write into it), the ρ/Xa digests
# of the untraced fit it must reproduce, that fit's untraced pass times (s) on this card
# and the chunk spans' device seconds predicted from §6's stand-alone times
TRACE_FIT = Path(__file__).resolve().parent / "build" / "trace_fit"
FIT_DIGEST = ("b54e6ae571e3ebb9", "c9e1e7e2eaa72162")
UNTRACED_PASS_S = (37.93, 20.16)
PREDICTED_CHUNK_S = (16 * 2 * (431.877 + 405.981) / 1e3,
                     16 * (2 * 431.877 + 2 * 2.512 + 2.495) / 1e3)

# the store phase at Europarl width: 8 full 512-row chunks and a 256-row tail
# (two merge groups), 2 chunks a shard (verify() hashes its 10 files in parallel)
STORE_N = 4352
STORE_CHUNK = 512
STORE_SHARD_ROWS = 1024

# the p = 910 fit's sketch (k = 60) and the power pair's narrow A (one ΔY bucket)
KT_910 = 970
DA_NARROW = 1024

# the sharded fit at Europarl width: one 8192-row chunk on a 1 × 1 × 2 mesh
# (two ranks sharing the card over gloo), two microbatches per pass
DIST_MICROBATCH = 4096
DIST_SHAPE = (1, 1, 2)
COLLECTIVES = ("unfused", "fused", "fused-int8ef")

GEMM = "src/repro_torch/kernels/csrc/gemm_f32.cu"
GEMM_BF16 = "src/repro_torch/kernels/csrc/gemm_bf16.cu"
RECOMPUTE = "src/repro_torch/kernels/csrc/recompute_f32.cu"
FUSED = ("projgram", "projgram_seeded", "power_project_accumulate",
         "power_project_accumulate_seeded")
SOURCES = {name: GEMM for name in ("proj_stage", "powerpass_sweep", "gram_sweep",
                                   "matmul_tn", "proj_stage_seeded", "matmul_nn")}
SOURCES["omega_fill"] = "src/repro_torch/kernels/csrc/rand.cuh"
SOURCES["project_rows"] = "src/repro_torch/kernels/csrc/gemm_rows.cu"
SOURCES.update({name: RECOMPUTE for name in FUSED})
REPLACES = {
    "proj_stage": "src/repro/kernels/powerpass.py:406",
    "powerpass_sweep": "src/repro/kernels/powerpass.py:445",
    "gram_sweep": "src/repro/kernels/projgram.py:362",
    "matmul_tn": "src/repro/kernels/matmul.py:54",
    "matmul_nn": "src/repro/kernels/matmul.py:34",
    "project_rows": "src/repro/serve/projector.py:50",
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


def time_ms(fn, reps: int, *, warm: bool = True) -> float:
    """Median device time of ``fn`` over ``reps`` runs after one warm-up
    (none with ``warm=False``), each between two CUDA events."""
    import torch

    if warm:
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


def time_plain(fn) -> float:
    """A plain version at the main path's shapes, timed ``PLAIN_REPS``
    times without a warm-up of its own: it has just run on the same
    inputs in its check (the warm-up was cut for the time limit)."""
    return time_ms(fn, PLAIN_REPS, warm=False)


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
        t = {"ms": time_ms(kern, reps),
             "plain_ms": time_plain(plain) if heavy else time_ms(plain, reps),
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
         "plain_ms": time_plain(lambda: rand.omega_tile(seed, d, kt, device=dev)),
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
         "plain_ms": time_plain(lambda: ref.proj_stage_seeded_ref(b, seed, kt)),
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
             "plain_ms": time_plain(plain),
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
        t = {"ms": time_ms(call, reps),
             "plain_ms": time_plain(plain) if heavy else time_ms(plain, reps),
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


def pass_decomposition(events) -> list:
    """Per pass of a traced stream fit: (pass_idx, Σ device_s of its chunk
    spans, Σ device_s of its io_wait spans, its span's wall)."""
    spans = [e for e in events if e.get("ev") == "span"]
    out = []
    for p in sorted((e for e in spans if e["name"] == "pass"),
                    key=lambda e: e["attrs"]["pass_idx"]):
        i = p["attrs"]["pass_idx"]

        def dev_s(name):
            return sum(e.get("device_s", 0.0) for e in spans
                       if e["name"] == name and e["attrs"].get("pass_idx") == i)
        out.append((i, dev_s("chunk"), dev_s("io_wait"), p["dur"]))
    return out


def trace_fit_checks(rep, launches) -> None:
    """Phase 7's traced fit (``cca_fit --trace``): the untraced fit's
    digests, coverage ≥ 0.95, ``kernel_cost`` calls per entry point equal
    to the launch counters, ``device_s`` on every chunk and io_wait span,
    the modelled fold rate under the f32 peak; prints each pass's device
    seconds beside its wall, the predictions and the untraced pass
    times; then ``python -m repro_torch.obs export-trace`` (its ``main``,
    in this process) must write JSON with one X event per span.  The trace
    files are deleted after."""
    from repro_torch.obs import close as obs_close
    from repro_torch.obs import load_events
    from repro_torch.obs import report as obs_report
    from repro_torch.obs.__main__ import main as obs_main

    events = load_events(str(TRACE_FIT))
    r = obs_report.analyze(str(TRACE_FIT))
    spans = [e for e in events if e.get("ev") == "span"]
    timed = [e for e in spans if e["name"] in ("chunk", "io_wait")]
    chunks = [e for e in spans if e["name"] == "chunk"]
    calls = {k: v["calls"] for k, v in r["roofline"]["kernels"].items()}
    flops = sum(e["attrs"]["flops"] for e in chunks)
    chunk_dev = sum(e.get("device_s", 0.0) for e in chunks)
    rate = flops / chunk_dev if chunk_dev else float("inf")
    for i, c, w, wall in pass_decomposition(events):
        mine = [e for e in chunks if e["attrs"]["pass_idx"] == i]
        print(f"[smoke] traced fit pass {i}: each chunk's span on the card "
              f"{[round(e.get('device_s', 0.0), 3) for e in mine]} s, on the host "
              f"{[round(e['dur'], 3) for e in mine]} s", flush=True)
        print(f"[smoke] traced fit pass {i}: chunk spans {c:.3f} s on the card (predicted "
              f"{PREDICTED_CHUNK_S[i]:.1f} s from the stand-alone kernel times), io_wait spans "
              f"{w:.3f} s on the card, the rest {wall - c - w:.3f} s of the pass span's "
              f"{wall:.3f} s wall; fit's pass time {rep.pass_seconds[i]:.3f} s traced, "
              f"{UNTRACED_PASS_S[i]} s untraced", flush=True)
    for key, fd in r["roofline"]["folds"].items():
        print(f"[smoke] traced fit {key}: {fd['flops'] / 1e12:.3f} model TFLOP over "
              f"{fd['s']:.3f} s ({fd.get('clock', 'dur')}) = "
              f"{fd['model_gflops_per_s'] / 1e3:.3f} TFLOP/s (f32 peak "
              f"{F32_PEAK_FLOPS / 1e12:.0f})", flush=True)
    out = TRACE_FIT.parent / "trace_fit.json"
    obs_main(["export-trace", str(TRACE_FIT), "-o", str(out)])
    with open(out) as f:
        doc = json.load(f)
    out.unlink()
    got = {"digests (rho, Xa) unchanged": (digest(rep.result.rho),
                                           digest(rep.result.Xa)) == FIT_DIGEST,
           "coverage >= 0.95": r["coverage"] >= 0.95,
           "kernel_cost calls = launches": calls == launches,
           "device_s on every chunk and io_wait span": all("device_s" in e for e in timed)
           and len(chunks) == 2 * N_CHUNKS,
           "every fold row on the card's clock": all(fd.get("clock") == "device_s"
                                                     for fd in r["roofline"]["folds"].values()),
           "modelled fold rate < f32 peak": rate < F32_PEAK_FLOPS,
           "export-trace: one X event per span": sum(e["ph"] == "X" for e in doc["traceEvents"])
           == len(spans)}
    print(f"[smoke] traced fit: {len(events)} records, coverage {r['coverage']}, kernel_cost "
          f"calls {calls}, fold {flops / 1e12:.3f} model TFLOP / {chunk_dev:.3f} s = "
          f"{rate / 1e12:.3f} TFLOP/s; {got}", flush=True)
    obs_close()  # a later record in this process would open its file anew
    for f in TRACE_FIT.iterdir():
        f.unlink()
    if not all(got.values()):
        raise AssertionError("phase 7's traced fit failed a trace check")


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


def phase_fit(dev) -> tuple[dict, dict]:
    """The main path's four Europarl-width runs at p = 2000 (both passes
    staged); returns each kernel's launches in the run that drives it, and
    the kernels-engine fit's ``Xa``, ``Xb``, λ and Σρ (phase 18's warm
    start)."""
    import torch

    from repro_torch.configs.europarl_cca import config

    wl = config()
    argv = ["--device", dev.type, "--n-chunks", str(N_CHUNKS), "--seed", str(SEED)]
    print(f"[smoke] main path: Europarl width, n cut to {N_CHUNKS} chunks of 8192 rows "
          "(the time limit's cut), traced", flush=True)
    shutil.rmtree(TRACE_FIT, ignore_errors=True)
    try:
        rep_k, launches, peak_k, _ = run_fit(
            argv + ["--engine", "kernels", "--trace", str(TRACE_FIT)], "kernels engine")
    finally:
        os.environ.pop("RCCA_TRACE", None)  # set by --trace; the later fits are not traced
    trace_fit_checks(rep_k, launches)
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
    fit = {"Xa": rep_k.result.Xa, "Xb": rep_k.result.Xb, "sum_rho": float(rho_k.sum()),
           **{k: float(rep_k.result.diagnostics[k]) for k in ("lam_a", "lam_b")}}
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

    # the seeded path and its bitwise oracle, at PAIR_CHUNKS
    pair = ["--device", dev.type, "--n-chunks", str(PAIR_CHUNKS), "--seed", str(SEED)]
    npc = PAIR_CHUNKS
    rep_s, launches_s, peak_s, _ = run_fit(pair + ["--omega", "seeded"], "omega=seeded")
    pair_final = {"proj_stage": 2 * npc, "gram_sweep": 2 * npc, "matmul_tn": npc}
    want_seeded = {"proj_stage_seeded": 2 * npc, "powerpass_sweep": 2 * npc}  # 4 per chunk
    fit_checks(rep_s, "omega=seeded", [want_seeded, pair_final], ["staged", "staged"])
    seeded = [t.cpu() for t in rep_s.result[:3]]
    del rep_s
    rep_m, launches_m, peak_m, _ = run_fit(pair + ["--omega", "seeded-materialized"],
                                           "omega=seeded-materialized")
    # Ω for both views up front, then 4 per power chunk
    fit_checks(rep_m, "omega=seeded-materialized",
               [{"omega_fill": 2, "proj_stage": 2 * npc, "powerpass_sweep": 2 * npc},
                pair_final], ["staged", "staged"])
    oracle = [t.cpu() for t in rep_m.result[:3]]
    del rep_m
    same = [torch.equal(x, y) for x, y in zip(seeded, oracle)]
    rho_s = seeded[2].double()
    print(f"[smoke] seeded vs seeded-materialized bitwise (Xa, Xb, rho): {same}; "
          f"sum rho {float(rho_s.sum()):.6f}; max |rho_seeded - rho_kernels| = "
          f"{float((rho_s - rho_k).abs().max()):.3e} (another Ω)", flush=True)
    print(f"[smoke] peak device memory: materialized {peak_k:.2f} GB ({N_CHUNKS} chunks); "
          f"seeded {peak_s:.2f} GB, seeded-materialized {peak_m:.2f} GB ({PAIR_CHUNKS} chunks) "
          f"(closed groups kept on the card: {STACK_ON_CARD_PEAK_GB} GB)", flush=True)
    if not all(same):
        raise AssertionError("omega=seeded is not bitwise omega=seeded-materialized")
    if not rho_ok(rho_s):
        raise AssertionError("seeded fit's canonical correlations are not in [0, 1]")
    if not peak_s < peak_m:
        raise AssertionError("the seeded fit held more device memory than its materialized "
                             "twin")
    return {**launches, "omega_fill": launches_m.get("omega_fill", 0),
            "proj_stage_seeded": launches_s.get("proj_stage_seeded", 0)}, fit


def phase_fit_910(dev) -> dict:
    """The paper's p = 910 at Europarl width (k̃ = 970): the power pass
    stays staged, the final pass recomputes; kernels engine against the
    torch engine, then the q = 0 seeded fit bitwise its oracle.  Returns
    the fused projgram kernels' launches."""
    import torch

    argv = ["--device", dev.type, "--n-chunks", str(P910_CHUNKS), "--seed", str(SEED),
            "--p", "910"]
    print(f"[smoke] p = 910: Europarl width, k̃ = 970, n cut to {P910_CHUNKS} chunks",
          flush=True)
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

    q0 = ["--device", dev.type, "--n-chunks", str(PAIR_CHUNKS), "--seed", str(SEED), "--p",
          "910", "--q", "0"]
    npc = PAIR_CHUNKS
    rep_s, launches_s, peak_s, _ = run_fit(q0 + ["--omega", "seeded"], "p=910 q=0 seeded")
    fit_checks(rep_s, "p=910 q=0 seeded", [{"projgram_seeded": 2 * npc, "matmul_tn": npc}],
               ["recompute"])
    seeded = [t.cpu() for t in rep_s.result[:3]]
    del rep_s
    rep_m, _, peak_m, _ = run_fit(q0 + ["--omega", "seeded-materialized"],
                                  "p=910 q=0 seeded-materialized")
    fit_checks(rep_m, "p=910 q=0 seeded-materialized",
               [{"omega_fill": 2, "projgram": 2 * npc, "matmul_tn": npc}], ["recompute"])
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


def horst_kernel_cases(a, V):
    """Phase 17's three products at Horst's shape, the planted rows a
    (n, d) against V (d, k): per entry point (call, plain, timed call,
    library call, K, FLOPs, bytes, output shape).  The checked calls add
    into a copy of an accumulator holding one chunk's ΔY (``out=``, as
    every chunk after a pass's first does); the timed ones into one
    accumulator in place."""
    import torch

    from repro_torch.kernels import power_project_accumulate, powerpass_sweep, proj_stage, ref

    (n, d), k = a.shape, V.shape[1]
    P = proj_stage(a, V)
    acc0 = ref.powerpass_sweep_ref(a, P)
    acc = acc0.clone()
    flops = 2 * n * d * k
    return {
        "proj_stage": (lambda: proj_stage(a, V), lambda: ref.proj_stage_ref(a, V),
                       lambda: proj_stage(a, V), lambda: a @ V, d, flops,
                       4 * (n * d + d * k + n * k), (n, k)),
        "powerpass_sweep": (lambda: powerpass_sweep(a, P, out=acc0.clone()),
                            lambda: acc0 + ref.powerpass_sweep_ref(a, P),
                            lambda: powerpass_sweep(a, P, out=acc),
                            lambda: torch.addmm(acc, a.T, P), n, flops,
                            4 * (n * d + n * k + 2 * d * k), (d, k)),
        "power_project_accumulate": (
            lambda: power_project_accumulate(a, a, V, out=acc0.clone()),
            lambda: acc0 + ref.power_project_accumulate_ref(a, a, V),
            lambda: power_project_accumulate(a, a, V, out=acc),
            lambda: torch.linalg.multi_dot([a.T, a, V]), d + n, 2 * flops,
            4 * (n * d + d * k + 2 * d * k), (d, k)),
    }


def phase_horst_kernels(dev, a) -> None:
    """Phase 17: the kernels of streaming Horst at its skinny shape — the
    main path's planted rows (8192 × 2^19) against V of 2^19 × k = 60:
    ``proj_stage``, ``powerpass_sweep(out=)`` and ``power_project_accumulate
    (a, a, V, out=)`` on the schedule the rule resolves, each within
    4·√K·u of its plain version and bitwise repeatable, the last bitwise
    its staged pair; median times beside the plain version, one PyTorch
    call (yardstick only) and the bound, with the tile ``plan.f32_tile``
    picks, its tile count and waves."""
    import torch

    from repro_torch.configs.europarl_cca import config
    from repro_torch.kernels import (choose_powerpass_schedule, power_project_accumulate,
                                     powerpass_sweep, proj_stage)

    (n, d), k = a.shape, config().rcca.k
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 29)
    V = torch.randn((d, k), generator=g, device=dev)
    sched = choose_powerpass_schedule(n, d, d, k, accumulate=True)
    print(f"[smoke] horst kernels: rows {tuple(a.shape)}, V {tuple(V.shape)}; the rule's "
          f"schedule for aᵀ(a·V) into an accumulator: {sched}", flush=True)
    acc = torch.randn((d, k), generator=g, device=dev)
    staged = powerpass_sweep(a, proj_stage(a, V), out=acc.clone())
    same = torch.equal(power_project_accumulate(a, a, V, out=acc.clone()), staged)
    print(f"[smoke] horst kernels: power_project_accumulate(a, a, V, out=) == "
          f"powerpass_sweep(a, proj_stage(a, V), out=) bitwise: {same}", flush=True)
    if not same:
        raise AssertionError("horst: power_project_accumulate is not its staged pair bitwise")
    for name, (kern, plain, timed, lib, K, flops, nbytes, shape) in \
            horst_kernel_cases(a, V).items():
        err = check(f"horst {name}", kern, plain, K)
        print(tile_line(f"horst {name}", *shape), flush=True)
        t = {"ms": time_ms(timed, 3), "plain_ms": time_plain(plain),
             "library_ms": time_ms(lib, 3)}
        b = bound(flops, nbytes)
        print(f"[smoke] horst {name} at {(n, d)} → {k}: kernel {t['ms']:.3f} ms, plain "
              f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.3f} ms, bound "
              f"{b['bound_ms']:.3f} ms ({b['bound_by']}); {flops / t['ms'] / 1e9:.1f} "
              f"TFLOP/s; max_abs_err {err:.3e}", flush=True)


class TimedSource:
    """A ``source_factory`` over the first ``chunks`` chunks of ``data``:
    each call starts one data pass, and records the wall since the last
    call after a device sync (a pass and the k × k algebra after it)."""

    def __init__(self, data, chunks: int):
        self.data, self.chunks = data, chunks
        self.marks: list = []

    def _mark(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())

    def __call__(self):
        self._mark()
        return (self.data.get_chunk(i) for i in range(self.chunks))

    def pass_seconds(self) -> list:
        self._mark()
        return [round(t1 - t0, 3) for t0, t1 in zip(self.marks, self.marks[1:])]


def horst_launches(passes: dict, n: int, da: int, db: int, k: int, chunks: int) -> dict:
    """The entry-point launches of a kernels-engine streaming Horst run:
    per chunk, a Gram pass is ``power_project_accumulate(x, x, V)`` on
    the schedule the rule resolves (staged: one ``proj_stage`` and one
    ``powerpass_sweep``; recompute: one launch per ΔY bucket), a combined
    pass one ``proj_stage`` and two ``powerpass_sweep``."""
    from repro_torch.kernels import choose_powerpass_schedule, plan

    want = {"proj_stage": passes["cross"] * chunks,
            "powerpass_sweep": 2 * passes["cross"] * chunks}
    for kind, d in (("gram_a", da), ("gram_b", db)):
        for i in range(chunks):  # the first chunk of a pass starts the accumulator
            if choose_powerpass_schedule(n, d, d, k, accumulate=i > 0) == "staged":
                want["proj_stage"] += passes[kind]
                want["powerpass_sweep"] += passes[kind]
            else:
                want["power_project_accumulate"] = (want.get("power_project_accumulate", 0)
                                                    + passes[kind] * len(plan.buckets(d, k)))
    return {name: v for name, v in want.items() if v}


def horst_run(label, source, da, db, cfg, n_rows, *, warm_a, **kw):
    """One streaming Horst run with the launch counters zeroed just before
    and read just after: its result, launches, pass seconds and peak;
    checks ρ ∈ [0, 1], finite X, the pass count against the reference's
    formula and, under the kernels engine, the launches against
    :func:`horst_launches`."""
    import torch

    from repro_torch.core.horst import horst_cca_streaming, streaming_passes
    from repro_torch.kernels import ops as kops

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    source.marks.clear()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    res = horst_cca_streaming(source, da, db, cfg, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kops.launch_counts()
    secs = source.pass_seconds()
    peak = torch.cuda.max_memory_allocated() / 1e9
    passes = streaming_passes(cfg.iters, cfg.cg_iters, warm_a)
    want = (horst_launches(passes, n_rows, da, db, cfg.k, source.chunks)
            if kw.get("engine", "kernels") == "kernels" else {})
    got = {"finite": all(bool(torch.isfinite(t).all()) for t in res[:3]),
           "rho in [0, 1]": rho_ok(res.rho),
           "passes = formula": int(res.objective_history[0]) == sum(passes.values())
           == len(secs),
           "launches = passes × chunks × ops table": launches == want}
    print(f"[smoke] horst {label}: wall {wall:.3f} s, passes {int(res.objective_history[0])} "
          f"({passes}) of {source.chunks} chunks, pass seconds {secs}, peak device memory "
          f"{peak:.2f} GB, launches {launches}, sum rho {float(res.rho.double().sum()):.6f}; "
          f"{got}", flush=True)
    if not all(got.values()):
        raise AssertionError(f"horst {label}: a check failed: {got}")
    return res, launches


def phase_horst(dev, fit: dict) -> dict:
    """Phase 18: Horst+rcca at Europarl width (d = 2^19, k = 60 uncut):
    streaming Horst over the first ``HORST_CHUNKS`` chunks of phase 7's
    planted rows (the same seed and rank), from phase 7's kernels-engine
    ``Xa``, ``Xb`` (warm: one iteration of 2 CG steps, kernels and torch
    engines) and from a seeded Gaussian (cold: one iteration of 3 CG steps,
    at least the warm run's passes).  λ is phase 7's, scaled to the rows
    Horst sees (the same ν).  The engines agree within 1e-3 and the warm
    Σρ is above the cold one (Table 2b's direction).  Returns the kernels
    runs' launches summed."""
    from repro_torch.configs.europarl_cca import config
    from repro_torch.core.horst import HorstConfig
    from repro_torch.launch import cca_fit

    wl = config()
    data = cca_fit.planted(wl, seed=SEED, n_chunks=N_CHUNKS, device=dev)
    source = TimedSource(data, HORST_CHUNKS)
    scale = HORST_CHUNKS / N_CHUNKS
    lam = {"lam_a": fit["lam_a"] * scale, "lam_b": fit["lam_b"] * scale}
    print(f"[smoke] horst: Europarl width, the first {HORST_CHUNKS} of phase 7's {N_CHUNKS} "
          f"chunks of {wl.chunk} rows, k = {wl.rcca.k}, lam {lam}", flush=True)
    n = wl.chunk
    warm_cfg = HorstConfig(k=wl.rcca.k, iters=1, cg_iters=2)
    warm = dict(init_Xa=fit["Xa"], init_Xb=fit["Xb"], **lam)
    runs = {}
    runs["warm"] = horst_run("warm (Horst+rcca), kernels engine", source, wl.da, wl.db,
                             warm_cfg, n, warm_a=True, device=dev, **warm)
    runs["cold"] = horst_run("cold (Gaussian), kernels engine", source, wl.da, wl.db,
                             HorstConfig(k=wl.rcca.k, iters=1, cg_iters=3), n, warm_a=False,
                             seed=SEED, device=dev, **lam)
    runs["torch"] = horst_run("warm (Horst+rcca), torch engine", source, wl.da, wl.db,
                              warm_cfg, n, warm_a=True, engine="torch", device=dev, **warm)
    rho = {key: r.rho.double().cpu() for key, (r, _) in runs.items()}
    gap = float((rho["warm"] - rho["torch"]).abs().max())
    got = {"|rho_kernels - rho_torch| <= 1e-3": gap <= 1e-3,
           "warm sum rho > cold sum rho": float(rho["warm"].sum()) > float(rho["cold"].sum()),
           "cold passes >= warm passes": int(runs["cold"][0].objective_history[0])
           >= int(runs["warm"][0].objective_history[0])}
    print(f"[smoke] horst: max |rho_kernels - rho_torch| = {gap:.3e}; sum rho warm "
          f"{float(rho['warm'].sum()):.6f}, cold {float(rho['cold'].sum()):.6f}, torch "
          f"{float(rho['torch'].sum()):.6f}; rcca's (16 chunks) {fit['sum_rho']:.6f}; top-5 "
          f"warm {[round(x, 6) for x in rho['warm'][:5].tolist()]}, cold "
          f"{[round(x, 6) for x in rho['cold'][:5].tolist()]}; {got}", flush=True)
    if not all(got.values()):
        raise AssertionError(f"horst: a check failed: {got}")
    total: dict = {}
    for key in ("warm", "cold"):
        for name, v in runs[key][1].items():
            total[name] = total.get(name, 0) + v
    return total


def phase_horst_smoke(dev) -> dict:
    """Phase 19, at the smoke width: dense ``horst_cca`` (Cholesky and CG;
    its three Grams by ``matmul_tn``) and streaming Horst (its Gram passes
    recompute: one ΔY bucket) on the card against the port's own CPU run
    on the same numpy rows and start, ρ within 1e-4 and sign-aligned X
    within 1e-3 relative (``tests/test_torch_horst.py``'s tolerances);
    then ``examples/europarl_cca_torch.py`` at its defaults (4,096 slots,
    kernels engine) must end in ``OK``.  Returns the Horst runs'
    launches (the example's, its fit's among them, are printed)."""
    import contextlib
    import importlib.util
    import io

    import numpy as np
    import torch

    from repro_torch.core.horst import (HorstConfig, horst_cca, horst_cca_streaming,
                                        streaming_passes)
    from repro_torch.data import planted_views
    from repro_torch.kernels import ops as kops

    A, B = (x.astype(np.float32) for x in planted_views(SEED, n=4096, da=256, db=192, rank=16))
    k = 8
    init = torch.randn((B.shape[1], k), generator=torch.Generator().manual_seed(SEED)).numpy()
    lam = 0.01 * float(np.sum(A * A)) / A.shape[1], 0.01 * float(np.sum(B * B)) / B.shape[1]

    def sign_rel(X, R):
        X, R = X.double().cpu(), R.double().cpu()
        X = X * torch.sign((X * R).sum(0, keepdim=True))
        return float(torch.linalg.norm(X - R) / torch.linalg.norm(R))

    def chunks():
        return ((A[lo:lo + 512], B[lo:lo + 512]) for lo in range(0, A.shape[0], 512))

    stream = HorstConfig(k=k, iters=3, cg_iters=3)
    dense = {"matmul_tn": 3}  # AᵀA, BᵀB, AᵀB
    runs = {  # label: (run on a device, the launches it must make on the card)
        "dense chol": (lambda d: horst_cca(A, B, HorstConfig(k=k, iters=20, nu=0.01),
                                           init_Xb=init, device=d), dense),
        # 4 CG steps a solve: with 8 the f32 CG runs past its rounding floor here,
        # and a 1e-7 relative change of the rows moves X by 5 % on the CPU alone
        "dense cg": (lambda d: horst_cca(A, B, HorstConfig(k=k, iters=10, nu=0.01, solver="cg",
                                                           cg_iters=4),
                                         init_Xb=init, device=d), dense),
        "streaming": (lambda d: horst_cca_streaming(chunks, A.shape[1], B.shape[1], stream,
                                                    init_Xb=init, lam_a=lam[0], lam_b=lam[1],
                                                    device=d),
                      horst_launches(streaming_passes(stream.iters, stream.cg_iters, False),
                                     512, A.shape[1], B.shape[1], k, A.shape[0] // 512)),
    }
    total: dict = {}
    for label, (run, want) in runs.items():
        kops.reset_launch_counts()
        card = run(dev)
        torch.cuda.synchronize()
        launches = kops.launch_counts()
        host = run("cpu")
        errs = {"rho": float((card.rho.double().cpu() - host.rho.double()).abs().max()),
                "Xa": sign_rel(card.Xa, host.Xa), "Xb": sign_rel(card.Xb, host.Xb)}
        ok = (errs["rho"] <= 1e-4 and errs["Xa"] <= 1e-3 and errs["Xb"] <= 1e-3
              and rho_ok(card.rho) and launches == want)
        print(f"[smoke] horst smoke {label}: card vs CPU {errs} (limits 1e-4, 1e-3), launches "
              f"{launches} (want {want}), sum rho {float(card.rho.double().sum()):.6f}: {ok}",
              flush=True)
        if not ok:
            raise AssertionError(f"horst smoke {label}: the card's run is not the CPU's")
        for name, v in launches.items():
            total[name] = total.get(name, 0) + v

    path = Path(__file__).resolve().parent / "examples" / "europarl_cca_torch.py"
    spec = importlib.util.spec_from_file_location("europarl_cca_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    kops.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = example.main(["--device", dev.type])
    wall = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        print(f"[smoke] europarl example | {line}", flush=True)
    launches = kops.launch_counts()
    print(f"[smoke] europarl example (defaults, {path.name}): wall {wall:.1f} s, launches "
          f"{launches}, horst rho in [0, 1]: {rho_ok(out['horst_rho'])}", flush=True)
    if lines[-1] != "OK" or not launches or not rho_ok(out["horst_rho"]):
        raise AssertionError("examples/europarl_cca_torch.py did not end in OK on the card")
    return total


# ---------------------------------------------------------------------------
# phase 20: the model zoo's serving path and activation harvesting
# ---------------------------------------------------------------------------

ZOO_TOL = 1e-5  # card ≡ CPU at the smoke width: tests/test_torch_models.py's
# phase 20(c): 8 token batches of 8 × 512 = 8 chunks of 4,096 rows, one merge group
HARVEST_BATCHES, HARVEST_BATCH, HARVEST_SEQ = 8, 8, 512


def rel_err(got, want) -> float:
    """max |got − want| over the largest |want|, on the host in f64."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def zoo_tokens(vocab: int, B: int, S: int, seed: int):
    import numpy as np
    import torch

    return torch.from_numpy(np.random.default_rng(seed).integers(0, vocab, (B, S), np.int32))


def zoo_smoke(dev) -> None:
    """Phase 20(a): each of the four archs' smoke configs in f32, the same
    weights on the CPU and the card: ``forward_hidden``, prefill and 4
    decode steps within ``ZOO_TOL`` of the CPU; on the card, prefill + one
    decode step against teacher forcing within 5e-4
    (``tests/test_models_smoke.py``).  gemma3's prompt of 40 tokens
    passes its window of 16, so its local layers mask."""
    from repro_torch.configs import get_config, model_archs
    from repro_torch.models import build_model

    for arch in model_archs():
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        host = build_model(cfg, device="cpu", seed=SEED)
        card = build_model(cfg, device=dev, seed=SEED + 1)
        card.load_state_dict(host.state_dict())
        S = 40 if cfg.attn.window else 24
        tok = zoo_tokens(cfg.vocab, 2, S + 5, SEED + 20)
        errs = {"hidden": rel_err(card.forward_hidden({"tokens": tok[:, :S]}),
                                  host.forward_hidden({"tokens": tok[:, :S]}))}
        hc, cc = host.init_cache(2, 64), card.init_cache(2, 64)
        errs["prefill"] = rel_err(card.prefill(tok[:, :S], cc)[0], host.prefill(tok[:, :S], hc)[0])
        errs["decode"] = max(rel_err(card.decode_step(tok[:, i:i + 1], cc)[0],
                                     host.decode_step(tok[:, i:i + 1], hc)[0])
                             for i in range(S, S + 4))
        full = card.forward_train({"tokens": tok[:, :S + 1]})
        cache = card.init_cache(2, 64)
        card.prefill(tok[:, :S], cache)
        teacher = float((card.decode_step(tok[:, S:S + 1], cache)[0][:, 0] - full[:, S])
                        .abs().max())
        ok = max(errs.values()) <= ZOO_TOL and teacher < 5e-4
        print(f"[smoke] zoo smoke {arch} (S = {S}): card vs CPU max rel err {errs} "
              f"(limit {ZOO_TOL}); prefill + decode vs teacher forcing on the card "
              f"{teacher:.3e} (limit 5e-4): {ok}", flush=True)
        if not ok:
            raise AssertionError(f"zoo smoke {arch}: the card's model is not the CPU's")
        del host, card


def zoo_serve(dev) -> dict:
    """Phase 20(b): granite-3-2b at full width.  In f32, prefill + one
    decode step against the teacher-forced logits of the same tokens,
    within 4·√(L·K)·u of the largest logit (K = d_ff, the widest
    contraction; L layers of such rounding adding like a random walk);
    then ``python -m repro_torch.launch.serve --arch granite-3-2b --batch
    8 --prompt-len 512 --gen 32`` (its ``main``, in this process) in the
    config's bf16."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("granite-3-2b"), dtype="float32")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev, seed=SEED)
    S = 64
    tok = zoo_tokens(cfg.vocab, 2, S + 1, SEED + 21)
    full = model.forward_train({"tokens": tok})[:, S]
    cache = model.init_cache(2, S + 8)
    model.prefill(tok[:, :S], cache)
    step = model.decode_step(tok[:, S:S + 1], cache)[0][:, 0]
    err, scale = float((step - full).abs().max()), float(full.abs().max())
    tol = 4 * math.sqrt(cfg.n_layers * cfg.ffn.d_ff) * U
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[smoke] zoo granite-3-2b f32 full width (d {cfg.d_model}, {cfg.n_layers} layers, "
          f"GQA {cfg.attn.n_heads}/{cfg.attn.n_kv}, vocab {cfg.vocab}), prompt {S}: prefill + "
          f"decode vs teacher forcing max abs err {err:.3e}, rel {err / scale:.3e} (limit "
          f"{tol:.3e}); peak device memory {peak:.2f} GB", flush=True)
    if not err <= tol * scale:
        raise AssertionError("granite-3-2b f32: decode disagrees with teacher forcing")
    del model, full, step, cache
    torch.cuda.empty_cache()
    rep = serve.main(["--arch", "granite-3-2b", "--batch", "8", "--prompt-len", "512",
                      "--gen", "32"])
    print(f"[smoke] zoo serve granite-3-2b bf16 batch 8, prompt 512, 32 tokens: prefill "
          f"{rep['prefill_ms']:.1f} ms, decode {rep['decode_ms_per_step']:.3f} ms per step, "
          f"{rep['tok_s']:.1f} tokens/s, peak device memory {rep['peak_gb']:.2f} GB", flush=True)
    torch.cuda.empty_cache()
    return rep


class HarvestSource:
    """A ``source_factory`` harvesting (granite rows, gemma3 rows) from
    the token batches, the second view's rows permuted per batch when
    ``shuffle`` (the control): each call starts one data pass.  Records
    each pass's wall (device sync at its start, as ``TimedSource``) and
    each chunk's model seconds (a sync before and after the harvest)."""

    def __init__(self, m1, m2, batches, shuffle: bool = False):
        self.m1, self.m2, self.batches, self.shuffle = m1, m2, batches, shuffle
        self.marks: list = []
        self.model_s: list = []

    def _pairs(self):
        import torch

        from repro_torch.core.harvest import activation_views, paired_activation_stream

        if not self.shuffle:
            yield from paired_activation_stream(self.m1, self.m2, iter(self.batches))
            return
        for i, batch in enumerate(self.batches):
            va, vb = activation_views(self.m1, batch), activation_views(self.m2, batch)
            g = torch.Generator(device=vb.device)
            g.manual_seed(40 + i)
            yield va, vb[torch.randperm(vb.shape[0], generator=g, device=vb.device)]

    def __call__(self):
        import torch

        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())

        def timed():
            it = self._pairs()
            while True:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pair = next(it, None)
                if pair is None:
                    return
                torch.cuda.synchronize()
                self.model_s.append(time.perf_counter() - t0)
                yield pair
        return timed()

    def pass_seconds(self) -> list:
        import torch

        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        return [round(t1 - t0, 3) for t0, t1 in zip(self.marks, self.marks[1:])]


def harvest_kernel_cases(a, b, Qa, Qb):
    """Phase 20(c)'s kernels at one harvested chunk: a (n, da), b (n, db)
    and Ω (Qa, Qb): per entry point (call returning a tuple, staged pair
    or None, plain call, library call or None, the K of each output,
    FLOPs, bytes).  The Gram's work counts its k̃(k̃+1)/2 distinct
    entries."""
    import torch

    from repro_torch.kernels import matmul_tn, power_project_accumulate, projgram, ref

    n, da = a.shape
    db, kt = b.shape[1], Qa.shape[1]
    pa, pb = ref.proj_stage_ref(a, Qa), ref.proj_stage_ref(b, Qb)
    gram_flops, gram_words = n * kt * (kt + 1), kt * (kt + 1) // 2
    return {
        "power_project_accumulate": (
            lambda: (power_project_accumulate(a, b, Qb),),
            lambda: (power_project_accumulate(a, b, Qb, schedule="staged"),),
            lambda: (ref.power_project_accumulate_ref(a, b, Qb),),
            lambda: torch.linalg.multi_dot([a.T, b, Qb]), (db + n,),
            2 * n * db * kt + 2 * n * da * kt, 4 * (n * da + n * db + db * kt + da * kt)),
        "projgram": (lambda: projgram(a, Qa), lambda: projgram(a, Qa, schedule="staged"),
                     lambda: ref.projgram_ref(a, Qa), None, (da, da + n),
                     2 * n * da * kt + gram_flops, 4 * (n * da + da * kt + n * kt + gram_words)),
        "matmul_tn": (lambda: (matmul_tn(pa, pb),), None, lambda: (ref.matmul_tn_ref(pa, pb),),
                      lambda: pa.T @ pb, (n,), 2 * n * kt * kt, 4 * (2 * n * kt + kt * kt)),
    }


def zoo_harvest(dev) -> dict:
    """Phase 20(c): views of granite-3-2b (da = 2048) against gemma3-1b (db
    = 1152), both bf16 at full width, rows cast to f32 by
    ``activation_views``, over ``HARVEST_BATCHES`` token batches of 8 × 512
    (one merge group of 4,096-row chunks); ``RCCAConfig(k=60, p=196, q=1,
    ν=0.01, center=True)`` (k̃ = 256) on the kernels engine, on the torch
    engine from the same Ω (|Δρ| ≤ 1e-3), and the shuffled-alignment
    control on the kernels engine (aligned Σρ above it by more than 0.5);
    launches against the ``ops`` table, schedules, seconds per pass and
    model seconds per chunk; then each kernel launched, at one chunk's
    shape, against its plain version (4·√K·u), bitwise repeatable (a
    recompute kernel bitwise its staged pair), timed beside its plain
    version, one PyTorch call and the bound.  Returns the kernels-engine
    fit's launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.rcca import RCCAConfig, draw_omega, randomized_cca_iterator
    from repro_torch.data import SyntheticTokenStream
    from repro_torch.kernels import ops as kops
    from repro_torch.models import build_model

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    c1, c2 = get_config("granite-3-2b"), get_config("gemma3-1b")
    m1, m2 = build_model(c1, device=dev, seed=SEED), build_model(c2, device=dev, seed=SEED + 1)
    # tokens from granite-3-2b's vocabulary (49,155), which gemma3-1b's contains
    stream = SyntheticTokenStream(vocab=c1.vocab, batch=HARVEST_BATCH, seq=HARVEST_SEQ, seed=3)
    batches = [{"tokens": torch.from_numpy(stream.get_batch(i)[:, :-1]).to(dev)}
               for i in range(HARVEST_BATCHES)]
    da, db = c1.d_model, c2.d_model
    cfg = RCCAConfig(k=60, p=196, q=1, nu=0.01, center=True)
    n = HARVEST_BATCH * HARVEST_SEQ
    want, schedules = {}, []
    for kind in ("power", "final"):
        cost = kops.chunk_cost(kind, n, da, db, cfg.sketch)
        schedules.append(cost["schedule"])
        for e in cost["entries"]:
            want[e["kernel"]] = want.get(e["kernel"], 0) + e["calls"] * HARVEST_BATCHES
    fits = {}
    for label, engine, shuffle in [("kernels", "kernels", False), ("torch", "torch", False),
                                   ("shuffled", "kernels", True)]:
        src = HarvestSource(m1, m2, batches, shuffle)
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        res = randomized_cca_iterator(src, da, db, cfg, seed=SEED, engine=engine, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kops.launch_counts()
        secs = src.pass_seconds()
        fits[label] = (res, launches)
        print(f"[smoke] zoo harvest {label} ({c1.name} {da} vs {c2.name} {db}, "
              f"{HARVEST_BATCHES} chunks of {n} rows, k̃ {cfg.sketch}): wall {wall:.3f} s, pass "
              f"seconds {secs}, model seconds per chunk {[round(s, 4) for s in src.model_s]}, "
              f"schedules {res.diagnostics['schedules']}, "
              f"launches {launches}, sum rho {float(res.rho.double().sum()):.6f}", flush=True)
        if not rho_ok(res.rho):
            raise AssertionError(f"zoo harvest {label}: rho outside [0, 1]")
    (rk, lk), (rt, lt), (rs, ls) = fits["kernels"], fits["torch"], fits["shuffled"]
    drho = float((rk.rho.double() - rt.rho.double()).abs().max())
    gap = float(rk.rho.double().sum() - rs.rho.double().sum())
    peak = torch.cuda.max_memory_allocated() / 1e9
    got = {"launches = ops table": lk == want and ls == want, "torch engine launches none":
           lt == {}, "schedules = the rule's": rk.diagnostics["schedules"] == schedules,
           "|drho| kernels vs torch <= 1e-3": drho <= 1e-3, "aligned - shuffled > 0.5": gap > 0.5}
    print(f"[smoke] zoo harvest: want launches {want} (the ops table × {HARVEST_BATCHES} "
          f"chunks), schedules {schedules}; max |rho_kernels - rho_torch| {drho:.3e}; aligned sum rho - shuffled "
          f"{gap:.6f}; top rho {[round(r, 4) for r in rk.rho[:5].tolist()]}; peak device "
          f"memory {peak:.2f} GB; {got}", flush=True)
    if not all(got.values()):
        raise AssertionError(f"zoo harvest: a check failed: {got}")

    from repro_torch.core.harvest import activation_views

    a, b = activation_views(m1, batches[0]), activation_views(m2, batches[0])
    del m1, m2, fits, rk, rt, rs
    Qa, Qb = draw_omega(SEED, da, db, cfg, device=dev)
    for name, (kern, staged, plain, lib, Ks, flops, nbytes) in \
            harvest_kernel_cases(a, b, Qa, Qb).items():
        if staged is None:
            err = check(f"harvest {name}", lambda: kern()[0], lambda: plain()[0], Ks[0])
        else:
            err = check_fused(f"harvest {name}", kern, staged, plain, Ks)
        t = {"ms": time_ms(kern, 10), "plain_ms": time_ms(plain, 10),
             "library_ms": None if lib is None else time_ms(lib, 10)}
        bd = bound(flops, nbytes)
        lib_txt = "none" if lib is None else f"{t['library_ms']:.4f} ms"
        print(f"[smoke] harvest {name} at a {tuple(a.shape)}, b {tuple(b.shape)}, k̃ "
              f"{cfg.sketch}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
              f"{lib_txt}, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}); "
              f"{flops / t['ms'] / 1e9:.1f} TFLOP/s; max_abs_err {err:.3e}; launches in the "
              f"kernels-engine fit {lk.get(name, 0)}", flush=True)
    del a, b, Qa, Qb, batches
    torch.cuda.empty_cache()
    return lk


def zoo_example(dev) -> None:
    """Phase 20(d): ``examples/activation_cca_torch.py`` at its defaults on
    the card must end in ``OK``."""
    import contextlib
    import importlib.util
    import io

    from repro_torch.kernels import ops as kops

    path = Path(__file__).resolve().parent / "examples" / "activation_cca_torch.py"
    spec = importlib.util.spec_from_file_location("activation_cca_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    kops.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = example.main(["--device", dev.type])
    wall = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        print(f"[smoke] activation example | {line}", flush=True)
    launches = kops.launch_counts()
    print(f"[smoke] activation example (defaults, {path.name}): wall {wall:.1f} s, launches "
          f"{launches}, gap {out['gap']:.3f}", flush=True)
    if lines[-1] != "OK" or not launches or not out["gap"] > 0.5:
        raise AssertionError("examples/activation_cca_torch.py did not end in OK on the card")


def phase_zoo(dev) -> dict:
    """Phase 20: the model zoo's serving path and activation harvesting
    (``zoo_smoke``, ``zoo_serve``, ``zoo_harvest``, ``zoo_example``);
    returns the harvested kernels-engine fit's launches."""
    zoo_smoke(dev)
    zoo_serve(dev)
    launches = zoo_harvest(dev)
    zoo_example(dev)
    return launches


def dist_job(runs: dict, n_ranks: int, label: str, smoke: bool = False) -> dict:
    """Several sharded fits (label → ``cca_fit.DistRun``) on ONE job of rank
    processes (``cca_fit.fit_dist_runs``: one spawn and rendezvous, the rows
    and Ω made once per mesh): at Europarl width one 8192-row chunk, at the
    smoke width the centered smoke workload, gathered.  The ranks are fresh
    processes whose launch counters each fit resets.  Returns label →
    report, printing each fit's passes and each rank's peak memory."""
    import torch

    from repro_torch.configs.europarl_cca import config, smoke_config
    from repro_torch.launch import cca_fit

    wl = config()
    if smoke:
        wl = smoke_config()
        wl = dataclasses.replace(wl, rcca=dataclasses.replace(wl.rcca, center=True))
    torch.cuda.empty_cache()  # the ranks need the card; this process holds nothing
    t0 = time.perf_counter()
    reps = cca_fit.fit_dist_runs(wl, list(runs.values()), n_ranks=n_ranks, device="cuda",
                                 seed=SEED, n_chunks=None if smoke else 1, gather=smoke)
    print(f"[smoke] {label}: one job of {len(runs)} fits on {n_ranks} ranks, wall "
          f"{time.perf_counter() - t0:.3f} s, backend {reps[0].backend}, ranks on "
          f"{reps[0].devices}", flush=True)
    out = {}
    for (name, run), rep in zip(runs.items(), reps):
        secs = [round(max(r["pass_seconds"][i] for r in rep.ranks), 3)
                for i in range(len(rep.ranks[0]["pass_seconds"]))]
        print(f"[smoke] dist {name}: mesh {run.mesh_shape}, engine {run.engine}, collective "
              f"{run.collective}, compute dtype {run.compute_dtype}: slowest rank's passes "
              f"{secs} s, peak memory per rank {[round(r['peak_gb'], 2) for r in rep.ranks]} GB "
              "(the job's first fit on a mesh includes making the data)", flush=True)
        cca_fit._print_dist(rep, wl.rcca)
        out[name] = rep
    return out


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


def dist_store_check(got, want) -> None:
    """``--mode dist --data``: the fit whose ranks read their rows from the
    store against the same job's fit of the rows made in memory, at
    tests/test_torch_dist.py's tolerances (ρ rtol 1e-4 / atol 1e-5; |Xa|,
    |Xb| rtol 5e-3 / atol 1e-4: the rows' columns are made whole on the
    card or read, and the products may round apart), with the same
    launches per rank and pass."""
    import numpy as np

    rho_ok_ = np.allclose(got.result.rho.numpy(), want.result.rho.numpy(), rtol=1e-4, atol=1e-5)
    x_ok = all(np.allclose(np.abs(getattr(got.result, f).cpu().numpy()),
                           np.abs(getattr(want.result, f).cpu().numpy()), rtol=5e-3, atol=1e-4)
               for f in ("Xa", "Xb"))
    same = [ra["pass_launches"] == rb["pass_launches"] for ra, rb in zip(got.ranks, want.ranks)]
    gap = float(np.abs(got.result.rho.numpy() - want.result.rho.numpy()).max())
    print(f"[smoke] dist smoke, rows from the store: max |Δrho| vs in memory {gap:.3e} (rtol "
          f"1e-4, atol 1e-5): {rho_ok_}; |Xa|, |Xb| within rtol 5e-3 / atol 1e-4: {x_ok}; "
          f"launches per rank as in memory: {same}", flush=True)
    if not (rho_ok_ and x_ok and all(same)):
        raise AssertionError("dist smoke: the fit from the store disagrees with the fit of "
                             "the same rows in memory")


def phase_dist(dev):
    """The sharded fit (``cca_fit.fit_dist_runs``, the ``--mode dist`` path):
    at Europarl width (one 8192-row chunk, p = 2000) two ranks on a
    1 × 1 × 2 mesh share the card over gloo, each collective on the
    kernels engine, then the torch engine, then the same fits at bf16
    (phase 11 checks those), all on one job; then stream mode on the same
    chunk and Ω; then the smoke width, centered, on one job of four ranks:
    1 × 2 × 2, where the row and the column sums are both real, under each
    collective in f32 and bf16, and 1 × 4 × 1 in bf16.  Returns
    matmul_nn's launches, the fused run's ρ and both jobs' reports."""
    import numpy as np
    import torch

    from repro_torch.configs.europarl_cca import smoke_config
    from repro_torch.launch import cca_fit

    run = functools.partial(cca_fit.DistRun, DIST_SHAPE, microbatch=DIST_MICROBATCH)
    print(f"[smoke] dist: Europarl width, n = 8192 (one chunk), mesh {DIST_SHAPE}, "
          f"microbatch {DIST_MICROBATCH}", flush=True)
    bf16 = {"compute_dtype": "bfloat16"}
    ereps = dist_job({"unfused": run(collective="unfused"), "fused": run(),
                      "fused-int8ef": run(collective="fused-int8ef"),
                      "torch engine": run(engine="torch"),
                      "bf16 unfused": run(collective="unfused", **bf16),
                      "bf16 fused": run(**bf16), "bf16 torch engine": run(engine="torch", **bf16)},
                     2, "dist Europarl")
    nb = 8192 // DIST_MICROBATCH
    dist_checks(ereps, nb, "dist Europarl")
    rep_t = ereps["torch engine"]
    if any(r["pass_launches"] != [{}, {}] for r in rep_t.ranks):
        raise AssertionError("the torch engine launched a kernel")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rep_s = cca_fit.main(["--device", "cuda", "--seed", str(SEED), "--n-chunks", "1"])
    rho_s = rep_s.result.rho.double().cpu().numpy()
    del rep_s
    rho_f = ereps["fused"].result.rho.numpy()
    gap_t = float(np.abs(rho_f - rep_t.result.rho.numpy()).max())
    gap_s = float(np.abs(rho_f - rho_s).max())
    print(f"[smoke] dist Europarl: max |rho_kernels - rho_torch| = {gap_t:.3e}, max "
          f"|rho_dist - rho_stream| = {gap_s:.3e} (limits 1e-3); sum rho {rho_f.sum():.6f}, "
          f"stream {rho_s.sum():.6f}; lam_a {ereps['fused'].result.diagnostics['lam_a']:.6g}",
          flush=True)
    if not gap_t <= 1e-3 or not gap_s <= 1e-3:
        raise AssertionError("dist Europarl: the fit disagrees with the torch engine or "
                             "with stream mode")

    print("[smoke] dist: smoke width, centered, 4 ranks on 1 × 2 × 2 and 1 × 4 × 1", flush=True)
    # the smoke rows in a view store (phase 14's directory): ``--mode dist --data``
    swl = smoke_config()
    sstore, secs = cca_fit.ingest(str(STORE_ROOT / "dist_smoke"), swl, seed=SEED, device=dev)
    print(f"[smoke] dist smoke: the rows ingested into {sstore.path} ({sstore.n} rows, "
          f"{sstore.nbytes / 1e9:.3f} GB) in {secs:.3f} s", flush=True)
    smoke = {c: cca_fit.DistRun((1, 2, 2), collective=c) for c in COLLECTIVES}
    smoke["fused, rows from the store"] = cca_fit.DistRun((1, 2, 2), store=sstore.path)
    smoke.update({f"bf16 {c}": cca_fit.DistRun((1, 2, 2), collective=c, **bf16)
                  for c in COLLECTIVES})
    smoke["bf16 1 x 4 x 1"] = cca_fit.DistRun((1, 4, 1), **bf16)
    sreps = dist_job(smoke, 4, "dist smoke", smoke=True)
    dist_checks(sreps, 1, "dist smoke")
    dist_store_check(sreps["fused, rows from the store"], sreps["fused"])
    shutil.rmtree(STORE_ROOT / "dist_smoke")
    torch.cuda.reset_peak_memory_stats()
    rep_ss = cca_fit.main(["--smoke", "--center", "--device", "cuda", "--seed", str(SEED)])
    gap = float(np.abs(sreps["fused"].result.rho.numpy()
                       - rep_ss.result.rho.double().cpu().numpy()).max())
    print(f"[smoke] dist smoke: max |rho_dist - rho_stream| = {gap:.3e} (limit 1e-3)",
          flush=True)
    if not gap <= 1e-3:
        raise AssertionError("dist smoke: the fit disagrees with stream mode")
    return ({"matmul_nn": sum(r["pass_launches"][0]["matmul_nn"]
                              + r["pass_launches"][1]["matmul_nn"]
                              for r in ereps["unfused"].ranks)}, rho_f, ereps, sreps)


def same_per_rank(a, b) -> list:
    """ρ and each rank's Xa, Xb digests equal, rank by rank."""
    import numpy as np

    return [np.array_equal(ra["rho"], rb["rho"]) and ra["digest"] == rb["digest"]
            for ra, rb in zip(a.ranks, b.ranks)]


def launches_of(reps, names) -> dict:
    """Each name's launches, summed over the ranks and passes of ``reps``."""
    return {n: sum(p.get(n, 0) for rep in reps for r in rep.ranks for p in r["pass_launches"])
            for n in names}


def phase_dist_bf16(dev, rho_f32, ereps, sreps) -> dict:
    """The sharded fit at ``compute_dtype=bfloat16``, from phase 9's jobs:
    at Europarl width on 1 × 1 × 2 ``unfused`` and ``fused`` on the kernels
    engine (bitwise equal per rank; the bf16 launches of the ``ops``
    table), the torch engine (|Δρ| ≤ 1e-3); then one rank on 1 × 1 × 1 (a
    job of its own), where the chunk updates run ``proj_stage[bf16]`` and
    ``powerpass_sweep[bf16,f32]`` (ρ within 1e-3 of the two-rank fused
    run); then the smoke width on four ranks, centered: 1 × 2 × 2 under all
    three collectives and 1 × 4 × 1, where both passes recompute (ρ within
    1e-3 of 1 × 2 × 2 fused).  ``rho_f32``: the f32 fused run's ρ at
    Europarl width, for |ρ_bf16 − ρ_f32|.  Returns each bf16 form's
    launches in the runs that drive it."""
    import numpy as np

    from repro_torch.launch import cca_fit

    reps = {c: ereps[f"bf16 {c}"] for c in ("unfused", "fused")}
    nb = 8192 // DIST_MICROBATCH
    for coll, rep in reps.items():
        for r in rep.ranks:
            want = dist_launches(coll, nb, bf16=True)
            if r["pass_launches"] != want or r["compute_dtype"] != "bfloat16":
                raise AssertionError(f"dist bf16 {coll} rank {r['rank']}: launches "
                                     f"{r['pass_launches']}, want {want}")
    same = same_per_rank(reps["unfused"], reps["fused"])
    rep_t = ereps["bf16 torch engine"]
    if any(r["pass_launches"] != [{}, {}] for r in rep_t.ranks):
        raise AssertionError("the torch engine launched a kernel")
    rep_1 = dist_job({"bf16 1 x 1 x 1": cca_fit.DistRun((1, 1, 1), microbatch=DIST_MICROBATCH,
                                                        compute_dtype="bfloat16")},
                     1, "dist bf16 1 x 1 x 1")["bf16 1 x 1 x 1"]
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

    sb = {c: sreps[f"bf16 {c}"] for c in COLLECTIVES}
    dist_checks(sb, 1, "dist bf16 smoke", bf16=True)
    rep_r = sreps["bf16 1 x 4 x 1"]
    want_r = [{"power_project_accumulate[bf16]": 2}, {"projgram[bf16]": 2, "matmul_tn": 1}]
    if any(r["pass_launches"] != want_r for r in rep_r.ranks):
        raise AssertionError(f"dist bf16 smoke 1 x 4 x 1: launches "
                             f"{[r['pass_launches'] for r in rep_r.ranks]}, want {want_r}")
    gap = float(np.abs(rep_r.result.rho.numpy() - sb["fused"].result.rho.numpy()).max())
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
         "plain_ms": time_plain(lambda: rand.omega_tile(seed, d, kt, device=dev).to(bf16)),
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
            t = {"ms": time_ms(call, 3), "plain_ms": time_ms(plain, PLAIN_REPS),
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
# the same data and Ω (the bf16 engines pair runs at BF16_PAIR_CHUNKS, which
# no f32 fit does)
F32_TWIN = {
    "stream bf16 seeded": "omega=seeded",
    "stream bf16 seeded-materialized": "omega=seeded-materialized",
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
    bfloat16)``): at Europarl width (p = 2000, both passes staged)
    ``--omega seeded`` bitwise ``seeded-materialized`` (``PAIR_CHUNKS``),
    and the materialized kernels engine against the torch engine
    (``BF16_PAIR_CHUNKS``, |Δρ| ≤ 1e-3);
    ``--p 910 --q 0`` seeded bitwise its oracle (the final pass
    recomputes); then the smoke width, centered, where both passes
    recompute: seeded bitwise its oracle, kernels against torch.  Each fit
    prints its launches by name, schedules, pass times, peak memory and
    Σρ beside the f32 fit's.  Returns each seeded bf16 form's and the bf16
    generator's launches in the run that drives it."""
    import torch

    bf16 = ["--compute-dtype", "bfloat16"]
    argv = ["--device", dev.type, "--n-chunks", str(BF16_PAIR_CHUNKS), "--seed",
            str(SEED)] + bf16
    print(f"[smoke] stream bf16: Europarl width, n cut to {BF16_PAIR_CHUNKS} chunks of 8192 "
          f"rows (kernels against torch; the seeded pairs at {PAIR_CHUNKS})", flush=True)
    nc, npc = BF16_PAIR_CHUNKS, PAIR_CHUNKS
    power = {"proj_stage[bf16]": 2 * nc, "powerpass_sweep[bf16,f32]": 2 * nc}
    final = {"proj_stage[bf16]": 2 * nc, "gram_sweep": 2 * nc, "matmul_tn": nc}
    pair = ["--device", dev.type, "--n-chunks", str(npc), "--seed", str(SEED)] + bf16
    pfinal = {"proj_stage[bf16]": 2 * npc, "gram_sweep": 2 * npc, "matmul_tn": npc}
    launches_s, launches_m, _ = bf16_fit_pair(
        pair, "stream bf16", [{"proj_stage_seeded[bf16]": 2 * npc,
                               "powerpass_sweep[bf16,f32]": 2 * npc}, pfinal],
        [{"omega_fill[bf16]": 2, "proj_stage[bf16]": 2 * npc,
          "powerpass_sweep[bf16,f32]": 2 * npc}, pfinal], ["staged", "staged"])
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

    q0 = ["--device", dev.type, "--n-chunks", str(npc), "--seed", str(SEED), "--p", "910",
          "--q", "0"] + bf16
    print(f"[smoke] stream bf16: p = 910, q = 0 (the final pass recomputes), {npc} chunks",
          flush=True)
    final_910 = {"projgram_seeded[bf16]": 2 * npc, "matmul_tn": npc}
    launches_910, _, _ = bf16_fit_pair(
        q0, "stream bf16 p=910 q=0", [final_910],
        [{"omega_fill[bf16]": 2, "projgram[bf16]": 2 * npc, "matmul_tn": npc}], ["recompute"])

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


def same_fit(x, y) -> bool:
    """ρ, Xa and Xb bitwise equal (two RCCAResults)."""
    import torch

    return all(torch.equal(u.cpu(), v.cpu()) for u, v in zip(x[:3], y[:3]))


def host_rss_gb() -> tuple[float, float]:
    """(current, peak) resident set of this process, GB."""
    import resource

    cur = 0.0
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            cur = int(line.split()[1]) * 1024 / 1e9
    return cur, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def store_fit(wl, reader, label, want_launches, want_schedules, **kw):
    """One store-backed fit through ``cca_fit.fit`` (prefetching
    ``PassRunner``), counters zeroed just before and read just after;
    prints its passes, IO lines, peak memory and digests."""
    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.launch import cca_fit

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = cca_fit.fit(wl, device="cuda", seed=SEED, store=reader, **kw)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[smoke] {label}: wall {wall:.3f} s, passes {rep.pass_seconds} s, schedules "
          f"{rep.pass_schedules}, peak device memory {peak:.2f} GB, launches "
          f"{kops.launch_counts()}, sum rho {float(rep.result.rho.double().sum()):.6f}, "
          f"sha256 rho {digest(rep.result.rho)}, Xa {digest(rep.result.Xa)}", flush=True)
    if rep.io is not None:
        cca_fit.print_io(rep.io)
    if want_launches is not None:
        fit_checks(rep, label, want_launches, want_schedules)
    return rep


class Kill(Exception):
    """A fit killed on purpose by its per-chunk callback."""


def kill_and_resume(reader, cfg, ckpt, kill_at, label, **kw):
    """Kill a store-backed kernels-engine fit at ``kill_at`` = (pass,
    chunk), just before the cursor save of that chunk, then resume it in a
    new runner → (the resumed result, its io)."""
    from repro_torch.store import PassRunner

    def crash(pass_idx, chunk_idx, *_):
        if (pass_idx, chunk_idx) == kill_at:
            raise Kill

    runner = PassRunner(reader, cfg, ckpt_dir=str(ckpt), device="cuda", **kw)
    t0 = time.perf_counter()
    try:
        runner.fit(seed=SEED, on_chunk=crash)
        raise AssertionError(f"{label}: the fit was not killed at {kill_at}")
    except Kill:
        pass
    finally:
        runner.close()
    killed = time.perf_counter() - t0
    saved = runner._cursors
    runner = PassRunner(reader, cfg, ckpt_dir=str(ckpt), device="cuda", **kw)
    t0 = time.perf_counter()
    try:
        res = runner.fit(seed=SEED, resume=True)
    finally:
        runner.close()
    io = res.diagnostics["io"]
    print(f"[smoke] {label}: killed at {kill_at} after {killed:.3f} s; cursors saved "
          f"{[(c['pass_idx'], c['next_chunk'], round(c['bytes'] / 1e9, 3), c['save_s']) for c in saved]} "
          f"(pass, next chunk, GB, s); resumed in {time.perf_counter() - t0:.3f} s from "
          f"{io['cursor_restored']}, {io['rows']} rows read of {2 * reader.n}", flush=True)
    if not io["resumed"] or not io["rows"] < 2 * reader.n:
        raise AssertionError(f"{label}: the resumed fit did not start from the cursor")
    return res, io


STORE_ROOT = Path(__file__).resolve().parent / "build" / "store_phase"


def europarl_store_wl():
    """Phase 14's Europarl-width workload: n cut to ``STORE_N`` rows in
    ``STORE_CHUNK``-row chunks, widths and sketch not cut."""
    from repro_torch.configs.europarl_cca import config

    return dataclasses.replace(config(), n=STORE_N, chunk=STORE_CHUNK)


def ingest_head(dev):
    """Write chunks 0-7 of phase 14's Europarl-width store (one merge
    group; the tail chunk is appended in phase 14) under ``STORE_ROOT``,
    on a thread while the kernels build: the rows are made on the card
    with torch's own operations (no kernel of the port is launched), then
    copied, hashed and written by the host → the thread's future of
    (reader, seconds).  Raises before writing when the target's free disk
    cannot hold the store with phase 14's cursors."""
    from repro_torch.launch import cca_fit

    shutil.rmtree(STORE_ROOT, ignore_errors=True)
    STORE_ROOT.mkdir(parents=True)
    wl = europarl_store_wl()
    nc = -(-wl.n // wl.chunk)
    store_bytes = wl.n * (wl.da + wl.db) * 4
    q_bytes = (wl.da + wl.db) * wl.rcca.sketch * 4
    # the power pass's cursor (Qa, Qb and one closed group) and the final
    # pass's (Qa, Qb) coexist while the second is written
    need = store_bytes + 2 * q_bytes + q_bytes
    free = shutil.disk_usage(STORE_ROOT).free
    print(f"[smoke] store: Europarl width, n = {wl.n} rows in chunks of {wl.chunk} ({nc} "
          f"chunks, two merge groups), {store_bytes / 1e9:.2f} GB on disk; cursors up to "
          f"{2 * q_bytes / 1e9:.2f} GB; {free / 1e9:.2f} GB free at {STORE_ROOT}", flush=True)
    if need > free:
        raise AssertionError(f"store phase: needs {need / 1e9:.2f} GB of disk, "
                             f"{free / 1e9:.2f} GB free")
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(cca_fit.ingest, str(STORE_ROOT / "europarl"), wl, seed=SEED,
                      n_chunks=nc - 1, device=dev, rows_per_shard=STORE_SHARD_ROWS)
    pool.shutdown(wait=False)
    return fut


def phase_store(dev, head) -> dict:
    """The out-of-core main path: ``cca_fit --data STORE`` through the
    view store, the prefetching ``PassRunner`` and the pass cursors.

    Smoke width (``cca_fit --smoke --data D --ingest``: the rows of
    ``DevicePlantedChunks`` on the card, 8 chunks of 512): the
    store-backed kernels fit bitwise the in-memory fit, materialized and
    ``--omega seeded``, within 1e-3 of the store-backed torch engine;
    prefetch 0 ≡ 2 ≡ ``auto`` bitwise; kill → resume bitwise at three
    points (mid power pass, at the power pass's end, mid final pass).

    Europarl width, f32 (da = db = 2^19, k = 60, p = 2000, q = 1):
    n = 4,352 rows in chunks of 512 — 8 full chunks and a 256-row tail,
    two merge groups, 18.3 GB on disk (the 8 chunks written while the
    kernels built, ``ingest_head``; the tail appended here).  The corpus's depth is cut for the
    disk and the time limit; widths and sketch are not.  Checks: the
    store's ``verify()``; the store-backed fit at prefetch 2 and at 0, each
    bitwise the in-memory fit of the same rows and Ω; one kill in the
    final pass after the first group's close (a cursor every 8 chunks:
    17.3 GB in the power pass, 8.7 GB in the final one), resumed bitwise
    the uninterrupted fit.  A resume from the power pass would be dearer:
    it redoes the 8.6 GB merge-group work of pass 0 and all of pass 1.  Prints ingest and verify GB/s,
    each pass's seconds, read and stall seconds and GB/s, the residency
    rule, peak device memory and host RSS, and each cursor's bytes and
    save and restore seconds.  The store and the cursors are deleted at
    the end, whatever happens.  Phases 15 and 16 run on these stores;
    returns phase 16's kernels-line row of ``project_rows``."""
    import torch

    from repro_torch.configs.europarl_cca import smoke_config
    from repro_torch.launch import cca_fit
    from repro_torch.store import ViewStoreReader, extend_chunks

    t_phase = time.perf_counter()
    root = STORE_ROOT  # ``ingest_head`` made it, and wrote the Europarl store's head there
    try:
        # -- smoke width ---------------------------------------------------
        smoke = ["--smoke", "--device", dev.type, "--seed", str(SEED)]
        data = ["--data", str(root / "smoke")]
        snc = 8
        power = [{"power_project_accumulate": 2 * snc}, {"projgram": 2 * snc, "matmul_tn": snc}]
        seeded = [{"power_project_accumulate_seeded": 2 * snc}, power[1]]
        rep_s, _, _, _ = run_fit(smoke + data + ["--ingest"], "store smoke, kernels engine")
        fit_checks(rep_s, "store smoke", power, ["recompute", "recompute"])
        rep_m, _, _, _ = run_fit(smoke, "smoke in memory, kernels engine")
        reps = {"0": run_fit(smoke + data + ["--prefetch", "0"], "store smoke, prefetch 0")[0],
                "auto": run_fit(smoke + data + ["--prefetch", "auto"],
                                "store smoke, prefetch auto")[0]}
        rep_ss, _, _, _ = run_fit(smoke + data + ["--omega", "seeded"], "store smoke, seeded")
        fit_checks(rep_ss, "store smoke seeded", seeded, ["recompute", "recompute"])
        rep_ms, _, _, _ = run_fit(smoke + ["--omega", "seeded"], "smoke in memory, seeded")
        rep_t, launches_t, _, _ = run_fit(smoke + data + ["--engine", "torch"],
                                          "store smoke, torch engine")
        gap = float((rep_s.result.rho.double() - rep_t.result.rho.double()).abs().max())
        checks = {"store ≡ in memory": same_fit(rep_s.result, rep_m.result),
                  "seeded store ≡ in memory": same_fit(rep_ss.result, rep_ms.result),
                  "prefetch 0 ≡ 2": same_fit(reps["0"].result, rep_s.result),
                  "prefetch auto ≡ 2": same_fit(reps["auto"].result, rep_s.result)}
        reader = ViewStoreReader(str(root / "smoke"))
        wl = smoke_config()
        for kill_at in [(0, 5), (1, 0), (1, 5)]:
            res, _ = kill_and_resume(reader, wl.rcca, root / f"ck_smoke_{kill_at[0]}_{kill_at[1]}",
                                     kill_at, f"store smoke kill {kill_at}", ckpt_every=2)
            checks[f"kill {kill_at} → resume ≡ uninterrupted"] = same_fit(res, rep_s.result)
        print(f"[smoke] store smoke: {checks}; max |rho_kernels - rho_torch| = {gap:.3e} "
              "(limit 1e-3)", flush=True)
        if not all(checks.values()) or launches_t or not gap <= 1e-3:
            raise AssertionError("store smoke: a store-backed fit is not bitwise its twin, "
                                 "or the engines disagree")
        del rep_s, rep_m, rep_ss, rep_ms, rep_t, reps, res

        # -- Europarl width ------------------------------------------------
        wl = europarl_store_wl()
        cfg = wl.rcca
        nc = -(-wl.n // wl.chunk)
        # written in two steps: chunks 0-7 while the kernels built (one
        # merge group: the delta refit's alignment contract), then the tail
        # chunk appended — the rows and shards of one ingest
        path = str(root / "europarl")
        reader, secs = head.result()
        print(f"[smoke] store: ingested chunks 0-{nc - 2} while the kernels built: {reader.n} "
              f"rows, {len(reader.shards)} shards, {reader.nbytes / 1e9:.3f} GB in {secs:.3f} s "
              f"({reader.nbytes / secs / 1e9:.3f} GB/s: made on the card, copied to the host, "
              "hashed and written)", flush=True)
        fitted = serve_v1(dev, reader, cfg)  # phase 16: the fit of the 8-chunk store
        t0 = time.perf_counter()
        tail = cca_fit.planted(wl, seed=SEED, device=dev).get_chunk(nc - 1)
        reader = extend_chunks(path, [tail], rows_per_shard=STORE_SHARD_ROWS)
        del tail
        print(f"[smoke] store: appended chunk {nc - 1} in {time.perf_counter() - t0:.3f} s: "
              f"{reader.n} rows, {len(reader.shards)} shards, {reader.nbytes / 1e9:.3f} GB",
              flush=True)
        t0 = time.perf_counter()
        reader.verify()
        secs = time.perf_counter() - t0
        print(f"[smoke] store: verify() re-hashed {reader.nbytes / 1e9:.3f} GB in {secs:.3f} s "
              f"({reader.nbytes / secs / 1e9:.3f} GB/s, page cache warm)", flush=True)
        want = [{"proj_stage": 2 * nc, "powerpass_sweep": 2 * nc},
                {"proj_stage": 2 * nc, "gram_sweep": 2 * nc, "matmul_tn": nc}]
        staged = ["staged", "staged"]
        pool = ThreadPoolExecutor(1)
        # phase 16's state is written beside the fits below: disk and host
        saving = pool.submit(serve_save, root, fitted)
        pool.shutdown(wait=False)
        def contended():  # a fit timed while phase 16's state is written beside it
            return "" if saving.done() else ", contended: phase 16's FitState save beside it"

        mem = store_fit(wl, None, "Europarl in memory, kernels engine" + contended(), want,
                        staged)
        ref = [t.cpu() for t in mem.result[:3]]
        del mem
        got = {}
        for depth in (2, 0):
            rep = store_fit(wl, reader, f"Europarl store, prefetch {depth}" + contended(), want,
                            staged, prefetch=depth)
            got[f"store prefetch {depth} ≡ in memory"] = same_fit(rep.result, ref)
            del rep
        # the delta refit of the grown store, from the saved state: deleted
        # after, before the kill's cursors take the disk
        delta = serve_delta(dev, root, reader, saving.result())
        res, _ = kill_and_resume(reader, cfg, root / "ck_europarl", (1, 8),
                                  "Europarl store kill in the final pass", ckpt_every=8, keep=1)
        got["kill (1, 8) → resume ≡ uninterrupted"] = same_fit(res, ref)
        print(f"[smoke] store Europarl: resumed sha256 rho {digest(res.rho)}, Xa "
              f"{digest(res.Xa)}", flush=True)
        del res
        rss, rss_peak = host_rss_gb()
        print(f"[smoke] store Europarl: {got}; host RSS {rss:.2f} GB now, {rss_peak:.2f} GB "
              f"peak over the whole run", flush=True)
        if not all(got.values()):
            raise AssertionError("store Europarl: a store-backed fit is not bitwise the "
                                 "in-memory fit")
        print(f"[smoke] store phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
        # phase 16's versions are published beside phase 15's Local seeded
        # fit (the cold fit the delta refit is held to), from host copies,
        # and served before its cluster child: the run's disk holds one
        # of the two at a time
        fitted["res"], delta["res"] = on_host(fitted["res"]), on_host(delta["res"])

        def smoke_beside():  # phase 16 at the smoke width, beside the cluster child
            proc = serve_smoke_start(root)
            return lambda: serve_smoke_end(proc)

        return phase_cluster(
            dev, root, reader, wl,
            beside_local=lambda: serve_publish(root, fitted, delta),
            after_local=lambda loc, published: phase_serve(dev, root, reader, wl, loc, delta,
                                                           published),
            beside_child=smoke_beside)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


CLUSTER_CHILD = "--cluster-child"
CLUSTER_TIMEOUT_S = 600  # the Europarl-width cluster fit's child, workers included


def cluster_child(store: str, cluster_dir: str) -> int:
    """The Europarl-width cluster fit, in a process of its own (its host
    memory does not stack on this script's): ``repro_torch.exec.fit`` with
    ``Cluster(n_workers=2)``, ``omega="seeded"`` and a worker cursor every
    8 chunks; prints the coordinator's passes and one ``[cluster] {json}``
    line: Σρ, the ρ and Xa digests, the per-pass diagnostics (the
    coordinator's host RSS after each merge among them) and its peak
    device memory."""
    import torch

    from repro_torch.configs.europarl_cca import config
    from repro_torch.exec import Cluster, fit
    from repro_torch.launch import cca_fit

    t0 = time.perf_counter()
    res = fit(store, config().rcca, SEED, topology=Cluster(n_workers=2), cluster_dir=cluster_dir,
              omega="seeded", ckpt_every=8, device="cuda")
    wall = time.perf_counter() - t0
    cl = res.diagnostics["cluster"]
    cca_fit.print_cluster(cl)
    print("[cluster] " + json.dumps({
        "wall_s": wall, "sum_rho": float(res.rho.double().sum()), "rho": digest(res.rho),
        "Xa": digest(res.Xa), "passes": cl["passes"],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}),
        flush=True)
    return 0


def cluster_trace_checks(trace_dir: Path, passes: list) -> dict:
    """Phase 15's traced cluster child: the protocol verdict, every
    process's role and coverage, the coordinator's publish, barrier and
    merge spans against its diagnostics (one clock: within 10 ms), and
    the workers' ``kernel_cost`` calls against their launches, summed."""
    from repro_torch.obs import load_events
    from repro_torch.obs import report as obs_report

    events = load_events(str(trace_dir))
    r = obs_report.analyze(str(trace_dir))
    spans = [e for e in events if e.get("ev") == "span"]
    coord = [e for e in spans if e.get("ctx", {}).get("role") == "coordinator"]
    gaps = {}
    for name, key in (("publish", "publish_s"), ("barrier", "barrier_s"), ("merge", "merge_s")):
        durs = [e["dur"] for e in coord if e["name"] == name]
        gaps[name] = ([round(d - p[key], 4) for d, p in zip(durs, passes)]
                      if len(durs) == len(passes) else None)
    calls, launched = {}, {}
    for e in events:
        if e.get("ev") == "ctr" and e["name"] == "kernel_cost":
            calls[e["fields"]["kernel"]] = calls.get(e["fields"]["kernel"], 0) + \
                e["fields"]["calls"]
    for p in passes:
        for k, v in p["launches"].items():
            launched[k] = launched.get(k, 0) + v
    roles = {pid: (p["role"], p["coverage"]["fraction"]) for pid, p in r["processes"].items()}
    barrier_t = {e["attrs"]["pass_idx"]: e["t"] for e in coord if e["name"] == "barrier"}
    for wp in sorted((e for e in spans if e["name"] == "worker_pass"),
                     key=lambda e: (e["attrs"]["pass_idx"], e["pid"])):
        i, mine = wp["attrs"]["pass_idx"], [e for e in spans if e["pid"] == wp["pid"]]

        def dev_s(name):
            return sum(e.get("device_s", 0.0) for e in mine if e["name"] == name)
        print(f"[smoke] cluster trace pass {i} {wp['ctx']['role']}: its fold starts "
              f"{wp['t'] - barrier_t.get(i, wp['t']):.3f} s after the barrier opens and takes "
              f"{wp['dur']:.3f} s: chunk spans {dev_s('chunk'):.3f} s and io_wait spans "
              f"{dev_s('io_wait'):.3f} s on the card, publish spans "
              f"{sum(e['dur'] for e in mine if e['name'] == 'publish'):.3f} s", flush=True)
    proto = r.get("protocol", {"events": 0, "violations": ["no protocol events"]})
    print(f"[smoke] cluster trace: {len(events)} records from {len(roles)} processes "
          f"(role, coverage) {sorted(roles.values())}; protocol {proto['events']} events, "
          f"violations {proto['violations']}; span − diagnostics s {gaps}; merge share "
          f"{r['merge']['share']}; kernel_cost calls {calls}", flush=True)
    return {"trace: protocol without violations": proto["events"] > 0
            and not proto["violations"],
            "trace: every process has a role": all(role != "proc" for role, _ in roles.values()),
            "trace: coverage >= 0.95 in every process": all(c >= 0.95 for _, c in roles.values()),
            "trace: publish, barrier, merge = diagnostics (10 ms)": all(
                g is not None and all(abs(x) <= 0.010 for x in g) for g in gaps.values()),
            "trace: kernel_cost calls = launches over the workers": calls == launched}


def dir_gb(path: Path) -> float:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file()) / 1e9


def sharded_smoke(sreader, scfg, local, local_launches) -> None:
    """The streaming Sharded topology at the smoke width (phase 14's smoke
    store: 8 chunks of 512, merge groups of 2, four groups): ``exec.fit``
    over two slots on the card (``SHARDED_SLOTS``: two streams), counters
    zeroed just before and read just after, sanitized: bitwise the Local
    fit, the same launches, its sanitizer trace the Local fit's record for
    record (the site aside); each batch's slot device seconds printed."""
    from repro_torch.analysis import sanitize
    from repro_torch.exec import Sharded, fit
    from repro_torch.kernels import ops as kops

    kops.reset_launch_counts()
    t0 = time.perf_counter()
    with sanitize.override(True):
        res = fit(sreader, scfg, SEED, topology=Sharded(devices=SHARDED_SLOTS), merge_group=2,
                  device="cuda")
    wall = time.perf_counter() - t0
    launches = kops.launch_counts()
    topo = res.diagnostics["topology"]
    checks = {"≡ Local": same_fit(res, local), "launches ≡ Local": launches == local_launches,
              "slots": topo["slots"] == list(SHARDED_SLOTS),
              "sanitizer trace ≡ Local": sanitize.first_divergence(
                  local.diagnostics["sanitize"], res.diagnostics["sanitize"],
                  ignore=("site",)) is None}
    print(f"[smoke] sharded smoke: exec.fit, Sharded(devices={SHARDED_SLOTS}): wall "
          f"{wall:.3f} s, passes {[p['seconds'] for p in topo['passes']]} s, slot device s per "
          f"batch {[p['slot_device_s'] for p in topo['passes']]}, schedules "
          f"{res.diagnostics['schedules']}, launches {launches}; {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError("sharded smoke: the Sharded fit is not bitwise the Local fit, or "
                             "its launches differ")


def sharded_europarl(reader, wl, want_digest, want_launches) -> None:
    """The streaming Sharded topology at Europarl width: phase 14's store
    (4,352 rows, 9 chunks of 512, two merge groups) with ``--omega
    seeded`` over two slots on the card (``cca_fit.fit(topology=
    "sharded")``), alone on the card: ρ and Xa bitwise the Local seeded
    fit (``want_digest``), its launches per pass the Local fit's; prints
    the pass times, peak device memory, each batch's slot device seconds
    and the residency rule's decision."""
    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.launch import cca_fit

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = cca_fit.fit(wl, device="cuda", seed=SEED, store=reader, omega="seeded",
                      topology="sharded", devices=SHARDED_SLOTS)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    topo = rep.topology
    got = (digest(rep.result.rho), digest(rep.result.Xa))
    checks = {"rho, Xa ≡ Local seeded": got == want_digest,
              "launches ≡ Local": rep.pass_launches == want_launches,
              "slots": topo["slots"] == list(SHARDED_SLOTS)}
    print(f"[smoke] sharded Europarl: omega=seeded over {topo['slots']}: wall {wall:.3f} s, "
          f"passes {rep.pass_seconds} s, schedules {rep.pass_schedules}, peak device memory "
          f"{peak:.2f} GB, launches {rep.pass_launches}, slot device s per batch "
          f"{[p['slot_device_s'] for p in topo['passes']]}, read "
          f"{[p['io']['read_s'] for p in topo['passes']]} s, stall "
          f"{[p['io']['io_stall_s'] for p in topo['passes']]} s, look-ahead "
          f"{[r['lookahead'] for r in topo['residency'].values()]}, host slots a slot "
          f"{topo['prefetch_depth']}; sum rho {float(rep.result.rho.double().sum()):.6f}, sha256 "
          f"rho {got[0]}, Xa {got[1]}; {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError("sharded Europarl: the Sharded fit is not bitwise the Local "
                             "seeded fit, or its launches differ")
    del rep
    torch.cuda.empty_cache()


FLIP_CHUNK = 5  # the smoke store's chunk whose bit the sanitizer must find: merge group 2


def sanitize_smoke(sreader, scfg, local, fits: dict) -> None:
    """Phase 15's sanitizer checks at the smoke width (merge groups of 2:
    four a pass).  ``fits`` maps each cluster or Hybrid fit's label to
    (its result, its combine span): at span 1 its trace must be the Local
    fit's record for record, the site aside (the coordinator's merge
    observes each partial as it enters the tree); at span 2 the Local
    trace's ``pass_end`` records, and its workers' group fingerprints the
    Local fit's groups.  Then the Local fit's chunks once more through the
    pass engine, sanitized, with one bit of chunk ``FLIP_CHUNK`` flipped:
    the first divergence from the Local trace must be pass 0's merge group
    ``FLIP_CHUNK // 2``."""
    import torch

    from repro_torch.analysis import sanitize
    from repro_torch.exec import PassEngine

    want = local.diagnostics["sanitize"]
    checks = {"Local trace: 4 groups and pass_end a pass": len(want) == 2 * 5}
    for label, (res, combine) in fits.items():
        got = res.diagnostics["sanitize"]
        if combine == 1:
            checks[f"{label}: trace ≡ Local"] = sanitize.first_divergence(
                want, got, ignore=("site",)) is None
            continue
        ends = [[r for r in t if r["label"] == "pass_end"] for t in (want, got)]
        checks[f"{label}: pass_end ≡ Local"] = sanitize.first_divergence(
            *ends, ignore=("site",)) is None
        groups = {(r["pass_idx"], r["label"]): r["digest"]
                  for p in res.diagnostics["cluster"]["passes"] for w in p["workers"]
                  for r in w.get("sanitize", [])}
        checks[f"{label}: worker groups ≡ Local"] = groups == {
            (r["pass_idx"], r["label"]): r["digest"] for r in want
            if r["label"].startswith("group:")}

    def flipped(c: int):
        a, b = sreader.get_chunk(c)
        if c == FLIP_CHUNK:
            a = a.clone()
            a.view(torch.int32)[0, 0] ^= 1 << 20  # one mantissa bit of one element
        return a, b

    with sanitize.override(True):
        res = PassEngine(scfg, engine="kernels", merge_group=2, device="cuda").run_stream(
            lambda: (flipped(c) for c in range(sreader.n_chunks)), sreader.da, sreader.db,
            seed=SEED, n_chunks=sreader.n_chunks)
    div = sanitize.first_divergence(want, res.diagnostics["sanitize"])
    at = None if div is None else (div["a"]["pass_idx"], div["a"]["label"], div["reason"])
    checks[f"bit of chunk {FLIP_CHUNK} flipped: first divergence at pass 0, group "
           f"{FLIP_CHUNK // 2}"] = at == (0, f"group:{FLIP_CHUNK // 2}", "digest")
    print(f"[smoke] analysis: sanitizer at the smoke width: Local trace {len(want)} records "
          f"{[(r['pass_idx'], r['label'], r['digest'][:12]) for r in want]}; the flipped fit's "
          f"first divergence {at} (record {None if div is None else div['index']}); "
          f"{checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError("analysis: a sanitizer trace differs from the Local fit's, or the "
                             "flipped bit was not found at its merge group")


def phase_cluster(dev, root: Path, reader, wl, beside_local=None, after_local=None,
                  beside_child=None):
    """The Cluster topology (``repro_torch.cluster``) on the card.

    Smoke width (phase 14's smoke store, 8 chunks of 512, merge groups of
    2: four groups): ``exec.fit`` with ``Cluster(n_workers=2)``, combine 1
    with worker 0 killed after chunk 2 of pass 0 (``RCCA_CLUSTER_KILL_AT``,
    its groups re-dispatched to a repair worker), and combine 2: each
    bitwise the Local store fit with the same merge groups; the combine-2
    fit's launches summed over its workers are the Local fit's.  The two
    run on threads, beside the Local seeded fit below (their wall is
    mostly their workers' start-up).

    Europarl width (phase 14's store: 4,352 rows, 9 chunks of 512, two
    merge groups, 18.3 GB): the Local store fit with ``--omega seeded``,
    then the cluster fit of the same store in a child process (two
    workers sharing the card, a worker cursor every 8 chunks, the pass-0
    round carrying the seeds): its ρ and Xa bitwise the Local fit's, its
    launches summed over the workers the Local fit's pass by pass, every
    worker on ``cuda:0``.  Prints each pass's publish, barrier, merge and
    boundary seconds, the GB of its round, partials and cursors, each
    worker's peak device memory and host RSS, and the free disk.  The
    cluster directories are deleted at the end, whatever happens.
    ``beside_local()`` runs on a thread beside the Local seeded fit,
    ``after_local(local_report, its result)`` right after that fit, beside
    the smoke cluster fits, and ``beside_child()`` just before the cluster
    child starts: it returns the call that ends what it started, made
    once the child is done; ``after_local``'s result is returned."""
    import torch

    from repro_torch.analysis import sanitize
    from repro_torch.cluster.worker import KILL_ENV
    from repro_torch.configs.europarl_cca import smoke_config
    from repro_torch.exec import Cluster, Hybrid, fit
    from repro_torch.kernels import ops as kops
    from repro_torch.store import ViewStoreReader

    t_phase = time.perf_counter()
    for ck in root.glob("ck_*"):  # phase 14's cursors: their disk goes to the cluster
        shutil.rmtree(ck, ignore_errors=True)
    try:
        # -- smoke width, and the Local seeded fit at Europarl width ----------
        sreader = ViewStoreReader(str(root / "smoke"))
        scfg = smoke_config().rcca
        kops.reset_launch_counts()
        with sanitize.override(True):  # this thread's fits only
            local = fit(sreader, scfg, SEED, merge_group=2, device="cuda")
        local_launches = kops.launch_counts()
        sharded_smoke(sreader, scfg, local, local_launches)

        def smoke_cluster(i, combine, env, topo):
            t0 = time.perf_counter()
            with sanitize.override(True):  # a thread of its own: its own trace
                res = fit(sreader, scfg, SEED, topology=topo, merge_group=2,
                          cluster_dir=str(root / f"cluster_smoke_{i}"),
                          combine_groups=combine, env_overrides=env, device="cuda",
                          worker_timeout=300)
            return res, time.perf_counter() - t0

        # (combine, fault injection, topology): two workers; two Hybrid workers
        # of two slots each on the card, one of them killed after its first group
        hybrid = Hybrid(2, 2, devices=SHARDED_SLOTS * 2)
        cases = {"combine 1, worker 0 killed at 0:2": (1, {0: {KILL_ENV: "0:2"}},
                                                       Cluster(n_workers=2)),
                 "combine 2": (2, None, Cluster(n_workers=2)),
                 "hybrid 2 × 2": (1, None, hybrid),
                 "hybrid 2 × 2, worker 0 killed after its first group": (
                     1, {0: {KILL_ENV: "0:1"}}, hybrid)}
        nc = reader.n_chunks
        want = [{"proj_stage_seeded": 2 * nc, "powerpass_sweep": 2 * nc},
                {"proj_stage": 2 * nc, "gram_sweep": 2 * nc, "matmul_tn": nc}]
        # the smoke cluster fits run on threads (each coordinator waits on its
        # worker processes; none launches a kernel in this process) while
        # the Local seeded fit of the Europarl store runs here
        with ThreadPoolExecutor(len(cases) + 1) as pool:
            futs = {label: pool.submit(smoke_cluster, i, *case)
                    for i, (label, case) in enumerate(cases.items())}
            side = pool.submit(beside_local) if beside_local is not None else None
            busy = "" if side is None else ", contended: phase 16's publishes beside it"
            loc = store_fit(wl, reader, "Europarl store, omega=seeded (Local)" + busy, want,
                            ["staged", "staged"], omega="seeded")
            side = None if side is None else side.result()
            beside = None if after_local is None else after_local(loc, side)
            smoke_out = {label: f.result() for label, f in futs.items()}
        checks = {}
        for label, (res, wall) in smoke_out.items():
            passes = res.diagnostics["cluster"]["passes"]
            summed = {}
            for p in passes:
                for k, v in p["launches"].items():
                    summed[k] = summed.get(k, 0) + v
            devices = sorted({w["device"] for p in passes for w in p["workers"]})
            slots = sorted({tuple(w.get("slots", [w["device"]])) for p in passes
                            for w in p["workers"]})
            print(f"[smoke] cluster smoke, {label}: wall {wall:.3f} s (beside the Local fit), "
                  f"passes {[p['wall_s'] for p in passes]} s, re-dispatched "
                  f"{[p['redispatched_groups'] for p in passes]}, partials merged "
                  f"{[p['merge_fan_in'] for p in passes]}, launches over the workers {summed}, "
                  f"workers on {devices}, slots {slots}, slot device s "
                  f"{[w.get('slot_device_s') for p in passes for w in p['workers']]}",
                  flush=True)
            checks[f"{label} ≡ Local"] = same_fit(res, local)
            checks[f"{label}: workers on cuda:0"] = devices == ["cuda:0"]
            if cases[label][2] is hybrid:
                checks[f"{label}: two slots a worker"] = slots == [SHARDED_SLOTS]
            if cases[label][1] is not None:
                checks[f"{label}: re-dispatched"] = passes[0]["redispatched_groups"] == [2]
            else:
                checks[f"{label}: launches ≡ Local"] = summed == local_launches
        print(f"[smoke] cluster smoke: {checks}", flush=True)
        if not all(checks.values()):
            raise AssertionError("cluster smoke: a cluster or hybrid fit is not bitwise the "
                                 "Local fit, or its launches or devices are wrong")
        sanitize_smoke(sreader, scfg, local, {label: (res, cases[label][0])
                                              for label, (res, _) in smoke_out.items()})

        # -- Europarl width --------------------------------------------------
        want_digest = (digest(loc.result.rho), digest(loc.result.Xa))
        want_sum = float(loc.result.rho.double().sum())
        want_launches = loc.pass_launches
        del loc
        torch.cuda.empty_cache()
        sharded_europarl(reader, wl, want_digest, want_launches)
        cdir = root / "cluster"
        free = shutil.disk_usage(root).free
        print(f"[smoke] cluster Europarl: {free / 1e9:.2f} GB of disk free before the fit",
              flush=True)
        end_beside = beside_child() if beside_child is not None else None
        t0 = time.perf_counter()
        # a session of its own: on a time-out its workers are killed with it;
        # traced (its workers inherit RCCA_TRACE)
        trace_dir = root / "cluster_trace"
        proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), CLUSTER_CHILD,
                                 reader.path, str(cdir)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, start_new_session=True,
                                env={**os.environ, "RCCA_TRACE": str(trace_dir)})
        try:
            stdout, stderr = proc.communicate(timeout=CLUSTER_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            if end_beside is not None:
                end_beside()
        wall = time.perf_counter() - t0
        print(stdout, end="", flush=True)
        if proc.returncode != 0:
            print(stderr[-20000:], file=sys.stderr, flush=True)
            raise AssertionError(f"cluster Europarl: the child exited with {proc.returncode}")
        out = json.loads([ln for ln in stdout.splitlines()
                          if ln.startswith("[cluster] ")][-1][len("[cluster] "):])
        gb = {d: round(dir_gb(cdir / d), 3) for d in ("rounds", "partials", "workers")}
        print(f"[smoke] cluster Europarl: child wall {wall:.3f} s (fit {out['wall_s']:.3f} s); "
              f"disk used: rounds {gb['rounds']} GB, partials {gb['partials']} GB, cursors "
              f"{gb['workers']} GB; {shutil.disk_usage(root).free / 1e9:.2f} GB free; "
              f"coordinator peak device memory {out['peak_gb']:.2f} GB, host RSS after "
              f"each merge {[p['rss_gb_after_merge'] for p in out['passes']]} GB", flush=True)
        for i, p in enumerate(out["passes"]):
            print(f"[smoke] cluster Europarl pass {i}: publish {p['publish_s']} s, barrier "
                  f"{p['barrier_s']} s, merge {p['merge_s']} s, boundary {p['boundary_s']} s; "
                  f"round {p['round_bytes'] / 1e9:.3f} GB, partials "
                  f"{p['partial_bytes'] / 1e9:.3f} GB, cursors {p['cursor_bytes'] / 1e9:.3f} GB; "
                  "workers (shard, device, groups, s, peak device GB, largest RSS GB) "
                  f"{[(w['shard'], w['device'], w['groups'], w['seconds'], round(w['peak_gb'], 2), round(w['rss_peak_gb'], 2)) for w in p['workers']]}",
                  flush=True)
        got = {"rho, Xa ≡ Local seeded": (out["rho"], out["Xa"]) == want_digest,
               "launches ≡ Local": [p["launches"] for p in out["passes"]] == want,
               "workers on cuda:0": all(w["device"] == "cuda:0" for p in out["passes"]
                                        for w in p["workers"]),
               "two workers a pass": all(len(p["workers"]) == 2 for p in out["passes"]),
               **cluster_trace_checks(trace_dir, out["passes"])}
        print(f"[smoke] cluster Europarl: sum rho {out['sum_rho']:.6f} (Local {want_sum:.6f}), "
              f"sha256 rho {out['rho']}, Xa {out['Xa']}; {got}", flush=True)
        if not all(got.values()):
            raise AssertionError("cluster Europarl: the cluster fit is not bitwise the Local "
                                 "seeded fit, or its launches or devices are wrong")
    finally:
        for d in root.glob("cluster*"):
            shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"[smoke] cluster phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return beside


SERVE_CHILD = "--serve-child"
SERVE_TIMEOUT_S = 400  # the smoke-width serve child
SERVE_NAME = "europarl-cca"
SERVE_WINDOW = 192  # the drift window: cca_serve's default
SERVE_CLIENTS = 16  # concurrent clients on each side of the swap
SERVE_ROWS = 4  # distinct request rows: each (row, version) product is made alone once


def serve_child(root: str) -> int:
    """Phase 16 at the smoke width, in a process of its own (its launch
    counters apart from those of the Local fit it runs beside):
    ``cca_serve --smoke`` on the card under each engine (its exit, the
    drift flagged, versions [1, 2] across the swap with none dropped, the
    correlation recovered; ``project_rows`` launched under the kernels
    engine, no kernel under the torch engine); then on ``cca_serve
    --smoke``'s geometry (28 × 20 features, 8 → 12 chunks of 128, merge
    groups of 2): the exact ``delta_refit`` bitwise the cold fit of the
    grown store for both engines and both Ω modes, the refit from a saved
    and loaded FitState too, a frozen refit followed by an exact refit from
    its saved state bitwise the cold fit, and the no-delta re-finalize
    bitwise the fit; then ``fit_with_state`` and the exact ``delta_refit``
    over ``Sharded(devices=SHARDED_SLOTS)`` (two streams on the card),
    bitwise the Local ones and the cold fit, with the Local launches.
    Prints one ``[serve] {json}`` line of the checks."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core.rcca import RCCAConfig
    from repro_torch.data import PlantedCCAData
    from repro_torch.exec import FitState, Sharded, delta_refit, fit, fit_with_state
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import cca_serve
    from repro_torch.store import ViewStoreReader, extend_chunks, ingest_chunks

    torch.backends.cuda.matmul.allow_tf32 = False
    root = Path(root)
    checks = {}
    trace_dir = root / "trace"
    for engine in ("kernels", "torch"):
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        traced = ["--trace", str(trace_dir)] if engine == "kernels" else []
        try:
            rep = cca_serve.serve(cca_serve.parse_args(
                ["--smoke", "--device", "cuda", "--engine", engine, "--store",
                 str(root / f"store_{engine}"), "--registry",
                 str(root / f"registry_{engine}")] + traced))
        finally:
            os.environ.pop("RCCA_TRACE", None)  # set by --trace
        launches = kops.launch_counts()
        if traced:
            checks.update(serve_trace_checks(trace_dir, rep))
            obs.close()
            shutil.rmtree(trace_dir)
        print(f"[smoke] serve smoke, cca_serve --engine {engine}: {time.perf_counter() - t0:.3f} "
              f"s, launches {launches}, projector {rep['projector']}", flush=True)
        checks[f"cca_serve {engine}: drift flagged, then recovered"] = \
            rep["drift_flagged"] and rep["recovered"] >= 0.8 * rep["baseline"]
        checks[f"cca_serve {engine}: versions [1, 2], none dropped"] = \
            rep["versions_seen"] == [1, 2] and rep["dropped"] == 0
        checks[f"cca_serve {engine}: launches"] = (launches.get("project_rows", 0) > 0
                                                   if engine == "kernels" else not launches)

    cfg = RCCAConfig(k=4, p=8, q=1, nu=0.01, center=True)
    data = PlantedCCAData(n=2048, da=28, db=20, rank=8, noise=0.4, seed=11, chunk=128)

    def chunks(lo, hi):
        return ((a.astype(np.float32), b.astype(np.float32))
                for a, b in map(data.get_chunk, range(lo, hi)))

    old = ingest_chunks(str(root / "old"), chunks(0, 8), chunk=128)
    ingest_chunks(str(root / "grown"), chunks(0, 8), chunk=128)
    grown = extend_chunks(str(root / "grown"), chunks(8, 12))
    colds = {}
    for engine in ("kernels", "torch"):
        for omega in ("materialized", "seeded"):
            kw = dict(merge_group=2, engine=engine, omega=omega, device="cuda")
            res0, state = fit_with_state(old, cfg, SEED, **kw)
            cold = colds[engine, omega] = fit(grown, cfg, SEED, **kw)
            res, _ = delta_refit(state, grown, device="cuda")
            checks[f"exact delta ≡ cold ({engine}, {omega})"] = same_fit(res, cold)
            checks[f"no delta ≡ fit ({engine}, {omega})"] = same_fit(
                delta_refit(state, old, device="cuda")[0], res0)
            state.save(str(root / "state"))
            checks[f"saved, loaded, exact delta ≡ cold ({engine}, {omega})"] = same_fit(
                delta_refit(FitState.load(str(root / "state")), grown, device="cuda")[0], cold)
    for omega in ("materialized", "seeded"):
        chain = str(root / f"chain_{omega}")
        ingest_chunks(chain, chunks(0, 8), chunk=128)
        _, state = fit_with_state(ViewStoreReader(chain), cfg, SEED, merge_group=2, omega=omega,
                                  device="cuda")
        extend_chunks(chain, chunks(8, 10))
        _, state = delta_refit(state, ViewStoreReader(chain), mode="frozen", device="cuda")
        state.save(str(root / "frozen"))
        extend_chunks(chain, chunks(10, 12))
        res, _ = delta_refit(FitState.load(str(root / "frozen")), ViewStoreReader(chain),
                             device="cuda")
        checks[f"frozen, then exact ≡ cold (kernels, {omega})"] = same_fit(
            res, colds["kernels", omega])
    sharded = Sharded(devices=SHARDED_SLOTS)
    for omega in ("materialized", "seeded"):  # the Sharded pair over two slots on the card
        kw = dict(merge_group=2, engine="kernels", omega=omega, device="cuda")
        runs = {}
        for name, topo in (("local", None), ("sharded", sharded)):
            extra = {} if topo is None else {"topology": topo}
            kops.reset_launch_counts()
            res0, state = fit_with_state(old, cfg, SEED, **kw, **extra)
            fws = kops.launch_counts()
            kops.reset_launch_counts()
            res, _ = delta_refit(state, grown, device="cuda", **extra)
            runs[name] = (res0, fws, res, kops.launch_counts())
        (l0, lf, ld, ll), (s0, sf, sd, sl) = runs["local"], runs["sharded"]
        print(f"[smoke] serve smoke, Sharded({SHARDED_SLOTS}) fit_with_state and delta_refit "
              f"({omega}): launches {sf} and {sl} (Local {lf} and {ll})", flush=True)
        checks[f"sharded fit_with_state ≡ Local, launches too ({omega})"] = \
            same_fit(s0, l0) and sf == lf
        checks[f"sharded exact delta ≡ cold, launches ≡ Local delta ({omega})"] = \
            same_fit(sd, colds["kernels", omega]) and sl == ll
    print("[serve] " + json.dumps({"checks": checks}), flush=True)
    return 0


def serve_trace_checks(trace_dir: Path, rep: dict) -> dict:
    """Phase 16's traced ``cca_serve --smoke`` (kernels engine): one
    ``delta_refit`` and one ``index_build`` span, ``serve_batch`` spans
    whose occupancies sum to the requests served, a ``serve_swap`` per
    swap, the two ``registry_publish`` counters, ``drift`` counters and
    the ``drift_signal`` of the shifted traffic; device seconds on the
    refit's chunk spans."""
    from repro_torch.obs import load_events

    events = load_events(str(trace_dir))

    def named(ev, name):
        return [e for e in events if e.get("ev") == ev and e["name"] == name]

    chunks = named("span", "chunk")
    got = {"serve trace: one delta_refit span": len(named("span", "delta_refit")) == 1,
           "serve trace: one index_build span": len(named("span", "index_build")) == 1,
           "serve trace: serve_batch occupancies = requests":
               sum(e["attrs"]["occupancy"] for e in named("span", "serve_batch"))
               == rep["projector"]["requests"],
           "serve trace: serve_swap counters": len(named("ctr", "serve_swap"))
           == rep["projector"]["swaps"] >= 1,
           "serve trace: two registry_publish counters": len(named("ctr", "registry_publish"))
           == 2,
           "serve trace: drift counters and a drift_signal": len(named("ctr", "drift")) >= 3
           and len(named("ctr", "drift_signal")) == 1,
           "serve trace: device_s on every chunk span": bool(chunks)
           and all("device_s" in e for e in chunks)}
    print(f"[smoke] serve trace: {len(events)} records, {len(named('span', 'serve_batch'))} "
          f"serve_batch spans, {len(chunks)} chunk spans "
          f"({sum(e.get('device_s', 0.0) for e in chunks):.4f} s on the card)", flush=True)
    return got


def tensor_gb(*trees) -> float:
    """GB held by the tensors of nested tuples, lists and dicts."""
    import torch

    def walk(x):
        if isinstance(x, torch.Tensor):
            yield x.numel() * x.element_size()
        elif isinstance(x, dict):
            for v in x.values():
                yield from walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                yield from walk(v)
    return sum(sum(walk(t)) for t in trees) / 1e9


def serve_v1(dev, reader, cfg) -> dict:
    """Phase 16 on the 8-chunk store, between its two ingest steps:
    ``fit_with_state`` with seeded Ω (one merge group) → {"res": the
    result, on the card until phase 15; "state": its FitState, on the host
    (its closed groups are host buffers; its final Q is copied there, so
    that the save beside phase 14's fits moves nothing off the card);
    "meta"}."""
    import torch

    from repro_torch.exec import fit_with_state
    from repro_torch.kernels import ops as kops

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    res, state = fit_with_state(reader, cfg, SEED, omega="seeded", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[smoke] serve Europarl: fit_with_state over chunks 0-{reader.n_chunks - 1} "
          f"({reader.n} rows), omega=seeded: wall {wall:.3f} s, passes "
          f"{[p['seconds'] for p in res.diagnostics['io']['passes']]} s, launches "
          f"{kops.launch_counts()}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, sum rho "
          f"{float(res.rho.double().sum()):.6f}; FitState: pass 0 payload "
          f"{state.passes[0].Qa!r}, stack depths "
          f"{[len(c.acc_stack) for c in state.passes.values()]}", flush=True)
    final = state.passes[cfg.q]
    final.Qa, final.Qb = final.Qa.cpu(), final.Qb.cpu()
    return {"res": res, "state": state, "meta": state.meta}


def side_stream(dev):
    """A stream of its own for a thread's copies to the card: they then
    neither wait for nor hold up the kernels on the default stream beside
    them (the tensors they copy are complete)."""
    import torch

    return torch.cuda.stream(torch.cuda.Stream(dev))


def serve_save(root: Path, fitted: dict) -> dict:
    """``FitState.save`` of the 8-chunk fit's state, from the host (beside
    phase 14's fits; the state is dropped after) → its GB, seconds and
    the free disk before."""
    state = fitted.pop("state")
    free = shutil.disk_usage(root).free
    need = tensor_gb([c.acc_stack for c in state.passes.values()],
                     [(c.Qa, c.Qb) for c in state.passes.values()]) * 1e9
    if need > free:
        raise AssertionError(f"serve Europarl: the FitState needs {need / 1e9:.2f} GB of disk, "
                             f"{free / 1e9:.2f} GB free")
    t0 = time.perf_counter()
    nbytes = state.save(str(root / "fitstate"))
    return {"state_gb": nbytes / 1e9, "save_s": time.perf_counter() - t0, "free_gb": free / 1e9}


def serve_smoke_start(root: Path):
    """Start phase 16's smoke-width child (``serve_child``) → the process."""
    d = root / "serve_smoke"
    d.mkdir()
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), SERVE_CHILD, str(d)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def serve_smoke_end(proc) -> None:
    """Collect the smoke-width child: its lines, and every check true."""
    t0 = time.perf_counter()
    try:
        stdout, stderr = proc.communicate(timeout=SERVE_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    print("\n".join(ln for ln in stdout.splitlines() if not ln.startswith("[serve] {")),
          flush=True)
    if proc.returncode != 0:
        print(stderr[-20000:], file=sys.stderr, flush=True)
        raise AssertionError(f"serve smoke: the child exited with {proc.returncode}")
    checks = json.loads([ln for ln in stdout.splitlines()
                         if ln.startswith("[serve] {")][-1][len("[serve] "):])["checks"]
    print(f"[smoke] serve smoke (child, waited {time.perf_counter() - t0:.3f} s after the "
          f"cluster child it ran beside): {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError("serve smoke: a delta refit is not bitwise its cold fit, or the "
                             "serving loop failed a check")


def serve_delta(dev, root: Path, reader, saved: dict) -> dict:
    """Phase 16 on the grown (9-chunk) store: ``FitState.load`` and the
    exact ``delta_refit``, counters zeroed just before and read just
    after; the FitState's files are deleted after.  Returns the refit's
    result (on the card), its launches, its state's metadata and its
    print-outs; phase 15's Local seeded fit (the cold fit) checks it."""
    import torch

    from repro_torch.exec import FitState, delta_refit
    from repro_torch.kernels import ops as kops

    t0 = time.perf_counter()
    state = FitState.load(str(root / "fitstate"))
    load_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    res, state2 = delta_refit(state, reader, mode="exact", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kops.launch_counts()
    d = res.diagnostics["delta"]
    print(f"[smoke] serve Europarl: FitState {saved['state_gb']:.3f} GB saved in "
          f"{saved['save_s']:.3f} s beside phase 14's fits ({saved['free_gb']:.2f} GB of disk "
          f"free before); FitState.load {load_s:.3f} s (leaves mapped, read when used); "
          f"delta_refit exact: wall {wall:.3f} s, passes "
          f"{[(p['chunks'], p['seconds']) for p in d['passes']]} (chunks, s), launches "
          f"{launches}, peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
          f"sha256 rho {digest(res.rho)}, Xa {digest(res.Xa)}, delta "
          f"{({k: v for k, v in d.items() if k != 'passes'})}", flush=True)
    meta = state2.meta
    del state, state2
    shutil.rmtree(root / "fitstate", ignore_errors=True)
    return {"res": res, "meta": meta, "launches": launches,
            "digest": (digest(res.rho), digest(res.Xa)),
            "delta": {k: v for k, v in d.items() if k != "passes"}}


def on_host(res):
    """An RCCAResult with its tensors copied to the host."""
    return res._replace(**{f: getattr(res, f).cpu() for f in ("Xa", "Xb", "rho", "Qa", "Qb")})


def serve_publish(root: Path, fitted: dict, delta: dict) -> dict:
    """Beside phase 15's Local seeded fit, from host copies: publish v1
    (the 8-chunk fit) and v2 (the delta refit, parent v1) → {version:
    (GB, s)}.  No kernel is launched and nothing moves to or from the
    card: the Local fit's launch counts and copies stay its own."""
    from repro_torch.serve import ModelRegistry

    reg = ModelRegistry(str(root / "registry"))
    free = shutil.disk_usage(root).free
    need = tensor_gb(list(fitted["res"][:5]), list(delta["res"][:5])) * 1e9
    if need > free:
        raise AssertionError(f"serve Europarl: v1 and v2 need {need / 1e9:.2f} GB of disk, "
                             f"{free / 1e9:.2f} GB free")
    published, parent = {}, None
    for res, meta in ((fitted.pop("res"), fitted["meta"]), (delta.pop("res"), delta["meta"])):
        t0 = time.perf_counter()
        parent = reg.publish(SERVE_NAME, res, fit_meta=meta, parent=parent)
        published[parent] = (dir_gb(root / "registry" / SERVE_NAME / f"v{parent:05d}"),
                             time.perf_counter() - t0)
        del res
    return published


def phase_serve(dev, root: Path, reader, wl, loc, delta: dict, published: dict) -> dict:
    """Phase 16 at Europarl width, right after phase 15's Local seeded fit
    ``loc`` (beside its smoke cluster fits, before its cluster child: the
    run's disk cannot hold the registry beside the cluster's files).
    The delta refit against ``loc``, the cold fit of the same store: its
    ρ/Xa digest ``loc``'s; its launches one chunk's pass-0 launches plus
    ``loc``'s pass-1 launches; ``delta_chunks`` 1 and ``refolded_chunks``
    10.  Then v1 and v2 (``published`` beside the Local fit) load, hashes
    verified, v2 on a side stream while the corpus index of view b is
    built and the drift monitor takes its baseline on held-out rows
    (chunk 9, past the store, same seed) and flags their pairing broken
    under v1; the ``BatchedProjector`` serves
    ``SERVE_CLIENTS`` concurrent clients on each side of the v1 → v2
    swap, each response bitwise ``project_rows`` of its row alone under its
    stamped version; a projector serving v1 answers requests for the
    index's first rows with the index's rows, bitwise; the monitor,
    rebound to v2, recovers.  Then ``serve_kernel``'s bitwise checks and
    times of ``project_rows``.  Prints the GB and seconds of each publish
    and load, batches, mean occupancy and ms per batch, the index's
    seconds and a top-5, and the free disk; deletes the registry.  Returns
    the kernels line's ``project_rows`` row: its serving launches (index,
    drift, projector) and ``serve_kernel``'s numbers."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import project_rows
    from repro_torch.launch import cca_fit
    from repro_torch.serve import BatchedProjector, CorpusIndex, DriftMonitor, ModelRegistry

    t_phase = time.perf_counter()
    nc = reader.n_chunks
    want = {k: v // nc for k, v in loc.pass_launches[0].items()}
    for k, v in loc.pass_launches[1].items():
        want[k] = want.get(k, 0) + v
    checks = {"delta refit: rho, Xa ≡ Local seeded store fit":
              delta["digest"] == (digest(loc.result.rho), digest(loc.result.Xa)),
              "delta refit: one chunk's pass-0 launches + the cold pass 1":
              delta["launches"] == want,
              "delta refit: delta_chunks 1, refolded_chunks 10":
              (delta["delta"]["delta_chunks"], delta["delta"]["refolded_chunks"]) == (1, nc + 1)}
    print(f"[smoke] serve Europarl: the delta refit against the Local seeded fit: launches "
          f"want {want}; {checks}", flush=True)

    reg = ModelRegistry(str(root / "registry"))
    v1, v2 = sorted(published)

    def load(v):
        with side_stream(dev):
            t0 = time.perf_counter()
            m = reg.load(SERVE_NAME, v, device=dev)
            torch.cuda.current_stream(dev).synchronize()
            return m, time.perf_counter() - t0

    m1, load1_s = load(v1)
    past = dataclasses.replace(wl, n=(nc + 1) * reader.chunk)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(load, v2)
        held = cca_fit.planted(past, seed=SEED, device=dev).get_chunk(nc)
        xa, xb = (v[:SERVE_WINDOW].cpu().numpy() for v in held)
        x512 = held[0].contiguous()  # the kernel's bitwise checks: a full 512-row bucket
        del held
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        index = CorpusIndex.from_store(m1, reader, view="b")
        index_s = time.perf_counter() - t0
        monitor = DriftMonitor(m1, window=SERVE_WINDOW, threshold=0.8)
        t0 = time.perf_counter()
        base = monitor.observe(xa, xb)
        perm = np.random.default_rng(7).permutation(SERVE_WINDOW)
        shifted = monitor.observe(xa, xb[perm])
        drift_s = time.perf_counter() - t0
        flagged = monitor.refit_needed
        m2, load2_s = fut.result()
    models = {m1.version: m1, m2.version: m2}
    print(f"[smoke] serve Europarl: published v{v1} ({published[v1][0]:.3f} GB) in "
          f"{published[v1][1]:.3f} s, then v{v2} ({published[v2][0]:.3f} GB, parent "
          f"{reg.meta(SERVE_NAME, v2)['parent']}) in {published[v2][1]:.3f} s, beside the "
          f"Local fit; loaded v1 in {load1_s:.3f} s, then v2 in {load2_s:.3f} s beside the "
          f"index and the drift windows, each hash verified; "
          f"{shutil.disk_usage(root).free / 1e9:.2f} GB of disk free", flush=True)
    rows = [xa[i % SERVE_ROWS] for i in range(2 * SERVE_CLIENTS)]
    proj = BatchedProjector(m1, max_batch=32)
    try:
        with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            before = [pool.submit(proj.project_a, rows[i], 600) for i in range(SERVE_CLIENTS)]
            before[0].result()  # traffic is flowing under v1 when the swap comes
            proj.swap(m2)
            after = [pool.submit(proj.project_a, rows[SERVE_CLIENTS + i], 600)
                     for i in range(SERVE_CLIENTS)]
            results = [f.result() for f in before + after]
    finally:
        proj.close()
    stats = proj.stats()
    # the index's first rows requested from a projector serving v1, the
    # index's version: each response must be the index's row, bitwise
    b0 = np.ascontiguousarray(reader.read_chunk(0)[1][:SERVE_ROWS], dtype=np.float32)
    with BatchedProjector(m1, max_batch=32) as proj1, ThreadPoolExecutor(SERVE_ROWS) as pool:
        index_rows = [f.result() for f in [pool.submit(proj1.project_b, r, 600) for r in b0]]
    monitor.rebind(m2)
    recovered = monitor.observe(xa, xb)
    serve_launches = kops.launch_counts().get("project_rows", 0)
    # each response against the product of its row alone under each
    # version (these launches, and the kernel checks' below, are not counted)
    alone = {(j, v): project_rows(torch.from_numpy(xa[j][None]).to(dev), m.Xa)[0].cpu()
             for j in range(SERVE_ROWS) for v, m in models.items()}
    bitwise = all(
        torch.equal(torch.from_numpy(r["emb"]), alone[i % SERVE_ROWS, v])
        == (v == r["version"]) for i, r in enumerate(results) for v in models)
    seen = sorted({r["version"] for r in results})
    idx, scores = index.topk(results[0]["emb"], k=5)
    checks.update({
        "drift flagged, then recovered": flagged and recovered >= 0.8 * base,
        "zero drops, versions [1, 2] seen": len(results) == 2 * SERVE_CLIENTS
        and seen == [v1, v2],
        "after the swap only v2": all(f.result()["version"] == v2 for f in after),
        "each response bitwise project_rows of its row alone, its version's only": bitwise,
        "index rows ≡ the projector's responses for them (v1)": all(
            r["version"] == v1 and np.array_equal(r["emb"], index.emb[i])
            for i, r in enumerate(index_rows)),
        "top-5, scores descending": idx.shape == (5,) and bool(np.all(np.diff(scores) <= 0))})
    print(f"[smoke] serve Europarl: corpus index of view b, {index.emb.shape[0]} rows in "
          f"{index_s:.3f} s, top-5 for a view-a request {idx.tolist()}; drift (window "
          f"{SERVE_WINDOW}): baseline {base:.4f}, pairing broken {shifted:.4f} → "
          f"refit_needed={flagged} ({drift_s:.3f} s), {recovered:.4f} under v{v2}; projector: "
          f"{len(results)} responses from {SERVE_CLIENTS} + {SERVE_CLIENTS} clients, versions "
          f"seen {seen}, {stats['batches']} batches, mean occupancy "
          f"{stats['mean_occupancy']:.2f}, {1e3 * stats['batch_s'] / stats['batches']:.3f} ms "
          f"a batch (rows to the card, project_rows, embeddings back); serving launches of "
          f"project_rows {serve_launches}", flush=True)
    row = serve_kernel(dev, index, reader, x512, m1, m2)
    checks.update(row.pop("checks"))
    print(f"[smoke] serve Europarl: {checks}", flush=True)
    torch.cuda.synchronize()
    del m1, m2, models, index, monitor, proj, proj1, x512
    shutil.rmtree(root / "registry", ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"[smoke] serve phase (after the Local fit): {time.perf_counter() - t_phase:.1f} s; "
          f"{shutil.disk_usage(root).free / 1e9:.2f} GB of disk free after", flush=True)
    if not all(checks.values()):
        raise AssertionError("serve Europarl: the delta refit is not bitwise the cold fit, "
                             "or a serving check failed")
    return {"launches": serve_launches, **row}


SERVE_BUCKETS = (1, 32, 512)  # the projector's smallest and largest buckets, the index's launch


def serve_kernel(dev, index, reader, x512, m1, m2) -> dict:
    """``project_rows`` (``gemm_rows.cu``) at the serving shapes, after the
    serving run (nothing here is counted): bitwise, the rows of a 512-row
    launch ≡ the same rows of a 32-row launch ≡ each row alone (a few), and
    the index's 256-row tail launch ≡ each of its rows alone; at buckets 1,
    32 and 512 against its plain version (``check``'s 4·√K·u), timed beside
    the plain version, one ``torch.matmul`` and the bound.  Returns the
    kernels line's row (bucket 512's times, the largest error) and its
    checks."""
    import numpy as np
    import torch

    from repro_torch.kernels import plan, project_rows, ref

    X = m2.Xa
    K, N = X.shape
    out = {M: project_rows(x512[:M].contiguous(), X) for M in SERVE_BUCKETS}
    few = (0, 1, 31, 255, 511)
    tail0 = reader.n - (reader.n_chunks - 1) * reader.chunk  # rows of the last chunk
    tail = torch.from_numpy(np.array(reader.read_chunk(reader.n_chunks - 1)[1],
                                     dtype=np.float32)).to(dev)
    tail_alone = torch.stack([project_rows(tail[i:i + 1], m1.Xb)[0]
                              for i in range(tail.shape[0])]).cpu().numpy()
    checks = {
        "512-row launch ≡ 32-row ≡ 1-row launch, bitwise":
            torch.equal(out[512][:32], out[32]) and torch.equal(out[512][:1], out[1]),
        f"rows {few} of the 512-row launch ≡ each alone": all(
            torch.equal(project_rows(x512[i:i + 1], X)[0], out[512][i]) for i in few),
        f"the index's {tail0}-row tail launch ≡ each row alone":
            np.array_equal(index.emb[-tail0:], tail_alone)}
    print(f"[smoke] serve project_rows bitwise: {checks}", flush=True)
    row = {"max_abs_err": 0.0}
    for M in SERVE_BUCKETS:
        x = x512[:M].contiguous()
        row["max_abs_err"] = max(row["max_abs_err"], check(
            f"serve project_rows at bucket {M}", lambda: project_rows(x, X),
            lambda: ref.project_rows_ref(x, X), K))
        t = {"ms": time_ms(lambda: project_rows(x, X), 10),
             "plain_ms": time_ms(lambda: ref.project_rows_ref(x, X), 3),
             "library_ms": time_ms(lambda: torch.matmul(x, X), 10)}
        b = bound(2 * M * K * N, 4 * (M * K + K * N + M * N))
        print(f"[smoke] serve project_rows at bucket {M} ({M}×{K} · {K}×{N}): kernel "
              f"{t['ms']:.4f} ms on the {plan.ROWS_TILES[plan.rows_tile(M)][0]}-row tile, "
              f"plain {t['plain_ms']:.3f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
              f"{[(p.kernel, p.grid) for p in plan.plan_project_rows(M, K, N)]}", flush=True)
        if M == SERVE_BUCKETS[-1]:
            row.update(t, **b)
    del out, tail
    return {**row, "checks": checks}


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
        k = re.search(r"gemm_rows14segment_kernelINS_4TileILi(\d)E", fn)
        if k:
            return f"serving segment kernel, {16 * int(k.group(1))}×64 tile"
        if "gemm_rows11tree_kernel" in fn:
            return "serving tree kernel"
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


def phase_analysis() -> None:
    """The static-analysis gate on the card, in this process: the
    architecture lint, the kernel contracts with the occupancy API's blocks
    per SM (``kernel_check.check_occupancy``: each tile's must be the
    plan's), and the protocol explorer; raises unless it prints
    ``ANALYZE: OK``.  The contracts' small probes launch kernels, so the
    launch counters are zeroed after it."""
    from repro_torch.analysis.__main__ import main as analyze
    from repro_torch.kernels import ops as kops

    t0 = time.perf_counter()
    rc = analyze([])
    kops.reset_launch_counts()
    print(f"[smoke] analysis: the gate took {time.perf_counter() - t0:.1f} s", flush=True)
    if rc != 0:
        raise AssertionError("analysis: the static-analysis gate failed (ANALYZE: FAIL)")


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
    four libraries, from ``cuobjdump -sass``: every kernel on the bf16
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
    for lib in ("gemm_f32", "gemm_bf16", "recompute_f32", "gemm_rows"):
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
    if sys.argv[1:2] == [CLUSTER_CHILD]:  # phase 15's child: the cluster fit
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        return cluster_child(*sys.argv[2:4])
    if sys.argv[1:2] == [SERVE_CHILD]:  # phase 16's child: the smoke width
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        return serve_child(sys.argv[2])
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
    head = ingest_head(dev)  # phase 14's store, while nvcc runs (host and disk work)
    build.build()
    print(f"[smoke] build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, entry in build.BUILD_LOG.items():
        print(f"[smoke] nvcc {build.LIBRARIES[name].name} ({entry['seconds']:.2f} s):\n"
              f"{entry['log']}", flush=True)
    ring_spills()
    sass_hmma()
    phase_analysis()
    t0 = time.perf_counter()
    head.exception()  # the card and the host to the timed phases alone
    print(f"[smoke] waited {time.perf_counter() - t0:.2f} s for phase 14's ingest", flush=True)

    from repro_torch.configs.europarl_cca import config
    from repro_torch.data import DevicePlantedChunks

    wl = config()
    a, b = DevicePlantedChunks(wl.chunk, wl.da, wl.db, rank=2 * wl.rcca.k, seed=SEED,
                               chunk=wl.chunk, device=dev).get_chunk(0)
    t_lap = [time.perf_counter()]

    def lap(name: str) -> None:  # each phase's wall, for the time limit's bookkeeping
        now = time.perf_counter()
        print(f"[smoke] phase wall, {name}: {now - t_lap[0]:.1f} s", flush=True)
        t_lap[0] = now

    rows = phase_kernels(dev, a, b)
    torch.cuda.empty_cache()
    rows["omega_fill"] = phase_omega(dev)
    torch.cuda.empty_cache()
    rows["proj_stage_seeded"] = phase_seeded(dev, b)
    torch.cuda.empty_cache()
    rows.update(phase_recompute(dev, a, b))
    torch.cuda.empty_cache()
    rows["matmul_nn"] = phase_matmul_nn(dev, a)
    torch.cuda.empty_cache()
    phase_horst_kernels(dev, a)
    lap("f32 kernels (3-6, 8, 17)")
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
    lap("bf16 kernels (10, 12)")
    launches = phase_smoke_fits(dev)
    fit_launches, fit = phase_fit(dev)
    launches.update(fit_launches)
    lap("f32 stream fits (7)")
    horst = phase_horst(dev, fit)
    del fit
    for name, v in phase_horst_smoke(dev).items():
        horst[name] = horst.get(name, 0) + v
    print(f"[smoke] horst launches (phases 18-19's kernels-engine Horst runs, the example's "
          f"apart): {horst}", flush=True)
    lap("horst (18-19)")
    launches.update(phase_fit_910(dev))
    lap("p = 910 fits (7)")
    launches.update(phase_stream_bf16(dev))
    lap("bf16 stream fits (13)")
    dist_launched, rho_f32, ereps, sreps = phase_dist(dev)
    launches.update(dist_launched)
    launches.update(phase_dist_bf16(dev, rho_f32, ereps, sreps))
    del ereps, sreps
    lap("dist (9, 11)")
    rows["project_rows"] = phase_store(dev, head)
    launches["project_rows"] = rows["project_rows"].pop("launches")
    lap("store, cluster, serve (14-16)")
    phase_zoo(dev)
    lap("zoo (20)")

    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches.get(name, 0), **row}
               for name, row in rows.items()]
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was not launched on the main path")
    if any(TRACE_FIT.iterdir()):
        raise AssertionError(f"a fit after phase 7's traced fit wrote into {TRACE_FIT}")
    TRACE_FIT.rmdir()
    print(f"[smoke] total wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
