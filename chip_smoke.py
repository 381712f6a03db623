#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout, one H100

Phases, each of which fails the run by raising:

1. device — needs CUDA; prints the card's name and power limit; turns
   TF32 off for every f32 product;
2. build — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels — each of the four entry points against its plain PyTorch
   version on the card, at the main path's shapes (8192 rows, d = 2^19,
   k̃ = 2060, from the planted generator) and at two ragged small
   shapes: max error, bitwise repeatability, median times beside the
   plain version, one ``torch.matmul`` of the same product (yardstick
   only) and the bound;
4. fit — the smoke width against the exact dense CCA, then the main
   path: ``repro_torch.launch.cca_fit`` at Europarl width (da = db =
   2^19, k = 60, p = 2000, q = 1, ν = 0.01, chunk 8192; n cut to
   16 chunks = 131,072 rows for the time limit, two merge groups, so the
   pairwise tree merges full-width stats once) with ``engine="kernels"``,
   launch counters zeroed just before and read just after, then with
   ``engine="torch"`` on the same data and Ω; their ρ must agree.

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
HBM_BYTES_PER_S = 3.35e12
U = 2.0 ** -24  # f32 unit roundoff
N_CHUNKS = 16  # two merge groups of 8: the pairwise tree merges once
SEED = 0

SOURCE = "src/repro_torch/kernels/csrc/gemm_f32.cu"
REPLACES = {
    "proj_stage": "src/repro/kernels/powerpass.py:406",
    "powerpass_sweep": "src/repro/kernels/powerpass.py:445",
    "gram_sweep": "src/repro/kernels/projgram.py:362",
    "matmul_tn": "src/repro/kernels/matmul.py:54",
}


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
    bytes) on the main path's operands — P = X·Q staged from the chunk.
    C = PᵀP is symmetric, so the Gram's work is its k̃(k̃+1)/2 distinct
    entries: n·k̃·(k̃+1) FLOPs and k̃(k̃+1)/2 words written."""
    from repro_torch.kernels import gram_sweep, matmul_tn, powerpass_sweep, proj_stage, ref

    pa, pb = ref.proj_stage_ref(a, Qa), ref.proj_stage_ref(b, Qb)
    n, da = a.shape
    kt = Qb.shape[1]
    return {
        "proj_stage": (lambda: proj_stage(b, Qb), lambda: ref.proj_stage_ref(b, Qb),
                       lambda: b @ Qb, b.shape[1], 2 * n * b.shape[1] * kt,
                       4 * (n * b.shape[1] + b.shape[1] * kt + n * kt)),
        "powerpass_sweep": (lambda: powerpass_sweep(a, pb),
                            lambda: ref.powerpass_sweep_ref(a, pb), lambda: a.T @ pb,
                            n, 2 * n * da * kt, 4 * (n * da + n * kt + da * kt)),
        "gram_sweep": (lambda: gram_sweep(pb), lambda: ref.gram_sweep_ref(pb),
                       lambda: pb.T @ pb, n, n * kt * (kt + 1),
                       4 * (n * kt + kt * (kt + 1) // 2)),
        "matmul_tn": (lambda: matmul_tn(pa, pb), lambda: ref.matmul_tn_ref(pa, pb),
                      lambda: pa.T @ pb, n, 2 * n * kt * kt, 4 * (2 * n * kt + kt * kt)),
    }


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


def phase_kernels(dev) -> dict:
    import torch

    from repro_torch.configs.europarl_cca import config
    from repro_torch.core.rcca import draw_omega
    from repro_torch.data import DevicePlantedChunks
    from repro_torch.kernels import powerpass_sweep, proj_stage

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)
    for n, d, kt in [(1000, 1000, 100), (333, 517, 67)]:  # ragged small shapes
        x = torch.randn((n, d), generator=g, device=dev)
        y = torch.randn((n, d), generator=g, device=dev)
        Qx = torch.randn((d, kt), generator=g, device=dev)
        Qy = torch.randn((d, kt), generator=g, device=dev)
        for name, (kern, plain, _, K, _, _) in cases(x, y, Qx, Qy).items():
            check(name, kern, plain, K)

    wl = config()
    data = DevicePlantedChunks(wl.chunk, wl.da, wl.db, rank=2 * wl.rcca.k, seed=SEED,
                               chunk=wl.chunk, device=dev)
    a, b = data.get_chunk(0)
    Qa, Qb = draw_omega(SEED, wl.da, wl.db, wl.rcca, device=dev)
    rows = {}
    for name, (kern, plain, lib, K, flops, nbytes) in cases(a, b, Qa, Qb).items():
        err = check(name, kern, plain, K)
        heavy = flops > 1e12
        reps = 3 if heavy else 10
        t = {"ms": time_ms(kern, reps), "plain_ms": time_ms(plain, reps),
             "library_ms": time_ms(lib, reps)}
        t_ops, t_bytes = flops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
        rows[name] = dict(max_abs_err=err, bound_ms=1e3 * max(t_ops, t_bytes),
                          bound_by="operations" if t_ops >= t_bytes else "bytes", **t)
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
    return rows


def phase_fit(dev) -> dict:
    import torch

    from repro_torch.configs.europarl_cca import config, smoke_config
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import cca_fit

    # smoke width on the card against the exact dense CCA
    rep = cca_fit.main(["--smoke", "--device", dev.type, "--seed", str(SEED)])
    ev = cca_fit.evaluate(rep, smoke_config(), seed=SEED, device=dev)
    print(f"[smoke] smoke width: feasibility {ev['feasibility']}, "
          f"exact-oracle gap {ev['gap']:.5f}", flush=True)
    if max(ev["feasibility"].values()) > 1e-4 or not 0 <= ev["gap"] < 0.05:
        raise AssertionError("smoke-width fit is infeasible or far from the exact CCA")

    wl = config()
    argv = ["--device", dev.type, "--n-chunks", str(N_CHUNKS), "--seed", str(SEED)]
    print(f"[smoke] main path: Europarl width, n cut to {N_CHUNKS} chunks of 8192 rows "
          "(the time limit's cut)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    rep_k = cca_fit.main(argv + ["--engine", "kernels"])
    wall_k = time.perf_counter() - t0
    launches = kops.launch_counts()
    peak_k = torch.cuda.max_memory_allocated() / 1e9
    nc = rep_k.n_chunks
    want_power = {"proj_stage": 2 * nc, "powerpass_sweep": 2 * nc}  # 4 per chunk
    want_final = {"proj_stage": 2 * nc, "gram_sweep": 2 * nc, "matmul_tn": nc}  # 5 per chunk
    print(f"[smoke] kernels engine: wall {wall_k:.3f} s, passes {rep_k.pass_seconds} s, "
          f"peak memory {peak_k:.2f} GB, launches {launches}", flush=True)
    if rep_k.pass_launches != [want_power, want_final]:
        raise AssertionError(f"launches per pass {rep_k.pass_launches}, "
                             f"want {[want_power, want_final]}")
    rho_k = rep_k.result.rho.double().cpu()
    Xa_shape = tuple(rep_k.result.Xa.shape)
    finite = all(bool(torch.isfinite(t).all()) for t in rep_k.result[:3])
    del rep_k
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    rep_t = cca_fit.main(argv + ["--engine", "torch"])
    wall_t = time.perf_counter() - t0
    peak_t = torch.cuda.max_memory_allocated() / 1e9
    print(f"[smoke] torch engine: wall {wall_t:.3f} s, passes {rep_t.pass_seconds} s, "
          f"peak memory {peak_t:.2f} GB, launches {kops.launch_counts()}", flush=True)
    if kops.launch_counts():
        raise AssertionError("the torch engine launched a kernel")
    rho_t = rep_t.result.rho.double().cpu()
    gap = float((rho_k - rho_t).abs().max())
    print(f"[smoke] max |rho_kernels - rho_torch| = {gap:.3e} (limit 1e-3); "
          f"sum rho {float(rho_k.sum()):.6f} vs {float(rho_t.sum()):.6f}", flush=True)
    if not finite or Xa_shape != (wl.da, wl.rcca.k) or rho_k.shape != (wl.rcca.k,):
        raise AssertionError(f"bad fit output: finite={finite} Xa {Xa_shape}")
    # ρ ≤ 1 holds exactly for λ > 0; 1e-5 leaves room for the f32
    # statistics only (f32 factorizations in finish overshot by 2e-4)
    if not bool(((rho_k >= 0) & (rho_k <= 1 + 1e-5)).all()):
        raise AssertionError("canonical correlations outside [0, 1]")
    if not gap <= 1e-3:
        raise AssertionError("kernels and torch engines disagree on rho")
    return launches


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

    card = card_line()
    print(f"[smoke] card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build()
    print(f"[smoke] build: {time.perf_counter() - t0:.2f} s", flush=True)
    if build.BUILD_LOG:
        print(f"[smoke] nvcc {build.SOURCE.name} ({build.BUILD_LOG['seconds']:.2f} s):\n"
              f"{build.BUILD_LOG['log']}", flush=True)

    rows = phase_kernels(dev)
    torch.cuda.empty_cache()
    launches = phase_fit(dev)

    kernels = [{"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
                "launches": launches.get(name, 0), **row} for name, row in rows.items()]
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was not launched on the main path")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
