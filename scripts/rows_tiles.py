#!/usr/bin/env python3
"""Measures the serving kernel's two segment tiles (``gemm_rows.cu``:
Tile0 16 × 64, Tile1 64 × 64), the record behind ``plan.rows_tile``'s
switch at 16 rows.  Needs one CUDA card:

    PYTHONPATH=src python3 scripts/rows_tiles.py

At K = 2^19, N = 60 and M = 1 .. 512 rows it launches ``gemm_rows_f32``
on each tile (forced here, through ``build.launch``: ``project_rows``
always takes ``plan.rows_tile``'s), checks that both give the bits of a
512-row launch, and prints each tile's median time (CUDA events) beside
one ``torch.matmul`` and the bound; at M = 1, 32 and 512 it also prints
the device time ``torch.profiler`` sees for ``project_rows`` and for
``torch.matmul``, which tells the kernels' time from the host's.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, matmul, plan, project_rows  # noqa: E402


def on_tile(x, X, tile):
    (M, K), N = x.shape, X.shape[1]
    rows = plan.rows_slice(M, K, N)
    out = torch.empty((M, N), device=x.device)
    part = torch.empty((plan.rows_segments(K), rows, N), device=x.device)
    build.launch("project_rows", "gemm_rows_f32", x.data_ptr(), X.data_ptr(), out.data_ptr(),
                 part.data_ptr(), M, N, K, rows, tile,
                 plan.copies(matmul._operand(x, K), matmul._operand(X, N)), matmul._stream(x))
    return out


def device_ms(fn, reps=10):
    """Every kernel's own time in a profiler window of ``reps`` calls, over ``reps``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages())
    return us / reps / 1e3


def main():
    if not torch.cuda.is_available():
        raise SystemExit("rows_tiles.py needs a CUDA card")
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    g = torch.Generator(device="cuda").manual_seed(0)
    K, N = 2 ** 19, 60
    x = torch.randn(512, K, device="cuda", generator=g)
    X = torch.randn(K, N, device="cuda", generator=g) / 30
    base = on_tile(x, X, 1)
    same = True
    for M in (1, 4, 8, 16, 32, 64, 128, 256, 512):
        xm = x[:M].contiguous()
        same &= all(torch.equal(on_tile(xm, X, t), base[:M]) for t in (0, 1))
        t = [cs.time_ms(lambda: on_tile(xm, X, tile), 10) for tile in (0, 1)]
        lib = cs.time_ms(lambda: torch.matmul(xm, X), 10)
        b = cs.bound(2 * M * K * N, 4 * (M * K + K * N + M * N))
        line = (f"M={M}: tile0 {t[0]:.4f} ms, tile1 {t[1]:.4f} ms, torch.matmul {lib:.4f} ms, "
                f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}), rows_tile picks "
                f"{plan.rows_tile(M)}")
        if M in (1, 32, 512):
            line += (f"; device time project_rows {device_ms(lambda: project_rows(xm, X)):.4f}"
                     f" ms, torch.matmul {device_ms(lambda: torch.matmul(xm, X)):.4f} ms")
        print(line, flush=True)
    print(f"both tiles bitwise the 512-row launch at every M: {same}", flush=True)
    if not same:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
