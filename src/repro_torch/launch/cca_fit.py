"""The paper's end-to-end driver, stream mode: RandomizedCCA over the
planted Europarl stand-in.

    PYTHONPATH=src python -m repro_torch.launch.cca_fit --smoke --device cpu --engine torch
    PYTHONPATH=src python -m repro_torch.launch.cca_fit --smoke --device cpu --omega seeded
    PYTHONPATH=src python -m repro_torch.launch.cca_fit --n-chunks 4  # Europarl width, card
    PYTHONPATH=src python -m repro_torch.launch.cca_fit --p 910 --n-chunks 4

Port of ``repro/launch/cca_fit.py --mode stream``.  Rows are made on the
device chunk by chunk (:class:`~repro_torch.data.DevicePlantedChunks`)
and streamed through Algorithm 1's q+1 data passes
(:func:`~repro_torch.core.rcca.randomized_cca_iterator`); Ω comes from
``--seed`` under ``--omega`` (``materialized``: drawn on the device;
``seeded``: the counter-based Ω, made slab by slab inside pass 0's
kernels; ``seeded-materialized``: the same Ω made up front).
``--n-chunks`` cuts n to that many chunks; ``--k``, ``--p`` and ``--q``
override the configuration's (the paper ran p ∈ {910, 2000}).  Prints
the wall time, kernel launches and resolved schedule (staged or
recompute) of every pass, Σρ and the top-5 ρ; at smoke width also the
feasibility residuals and the gap to the exact dense CCA.
"""

from __future__ import annotations

import argparse
import dataclasses
import resource
import time
from typing import NamedTuple

import torch

from ..configs.europarl_cca import CCAWorkload, config, smoke_config
from ..core.exact import exact_cca, feasibility_errors
from ..core.rcca import DEFAULT_ENGINE, OMEGA_MODES, RCCAResult, randomized_cca_iterator
from ..data.synthetic import DevicePlantedChunks
from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels import ops as kops


class FitReport(NamedTuple):
    result: RCCAResult
    n: int
    n_chunks: int
    pass_seconds: list  # wall time of each pass's fold (a power pass's orth
                        # falls in the next pass's interval)
    pass_launches: list  # kernel launches of each pass, by entry point
    pass_groups: list  # (merge groups closed, seconds the fold spent in the
                       # merge stack) of each pass
    pass_schedules: list  # schedule the kernels resolved in each pass (None:
                          # torch engine)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fit(wl: CCAWorkload, *, engine: str = DEFAULT_ENGINE, device=DEFAULT_DEVICE,
        seed: int = 0, n_chunks: int | None = None, omega: str = "materialized") -> FitReport:
    """Stream-mode fit of workload ``wl``, n cut to ``n_chunks`` chunks,
    Ω from ``seed`` under ``omega``.  Pass 0's interval includes making Ω
    (the seeded-materialized mode's two ``omega_fill`` launches)."""
    dev = resolve_device(device)
    cfg = wl.rcca
    n = wl.n if n_chunks is None else min(wl.n, n_chunks * wl.chunk)
    data = DevicePlantedChunks(n, wl.da, wl.db, rank=max(cfg.k * 2, 16), seed=seed,
                               chunk=wl.chunk, device=dev)
    pass_seconds, pass_launches, pass_groups = [], [], []
    _sync(dev)
    marks = {"t": time.perf_counter(), "launches": kops.launch_counts()}

    def on_pass_complete(pass_idx, kind, acc, Qa_, Qb_):
        _sync(dev)
        now, counts = time.perf_counter(), kops.launch_counts()
        pass_seconds.append(now - marks["t"])
        pass_launches.append({k: v - marks["launches"].get(k, 0) for k, v in counts.items()
                              if v != marks["launches"].get(k, 0)})
        pass_groups.append((acc.groups_done, acc.host_seconds))
        marks.update(t=now, launches=counts)

    res = randomized_cca_iterator(lambda: iter(data), wl.da, wl.db, cfg, seed=seed,
                                  omega=omega, engine=engine, n_chunks=data.n_chunks,
                                  on_pass_complete=on_pass_complete, device=dev)
    _sync(dev)
    return FitReport(res, n, data.n_chunks, pass_seconds, pass_launches, pass_groups,
                     res.diagnostics["schedules"])


def evaluate(rep: FitReport, wl: CCAWorkload, *, seed: int = 0,
             device=DEFAULT_DEVICE) -> dict:
    """Small-scale check of a fit: materializes the rows, then the
    feasibility residuals and the gap of Σρ to the exact dense CCA."""
    cfg = wl.rcca
    A, B = DevicePlantedChunks(rep.n, wl.da, wl.db, rank=max(cfg.k * 2, 16), seed=seed,
                               chunk=wl.chunk, device=device).materialize()
    lam_a = float(rep.result.diagnostics["lam_a"])
    lam_b = float(rep.result.diagnostics["lam_b"])
    feas = feasibility_errors(A, B, rep.result.Xa, rep.result.Xb, lam_a, lam_b)
    exact = float(exact_cca(A, B, cfg.k, lam_a, lam_b).rho.sum())
    return {"feasibility": {k: float(v) for k, v in feas.items()},
            "exact_sum_rho": exact, "gap": exact - float(rep.result.rho.sum())}


def main(argv=None) -> FitReport:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke width (4096 x 256/192, k=8, p=24)")
    ap.add_argument("--device", default=DEFAULT_DEVICE, choices=["cuda", "cpu"])
    ap.add_argument("--engine", default=DEFAULT_ENGINE, choices=["kernels", "torch"],
                    help="data-pass engine: the CUDA kernels (default) or the "
                         "plain PyTorch oracle path")
    ap.add_argument("--n-chunks", type=int, default=None,
                    help="cut n to this many row chunks")
    ap.add_argument("--omega", default="materialized", choices=list(OMEGA_MODES),
                    help="Ω provenance: drawn and held (materialized), made from the "
                         "seed inside pass 0's kernels (seeded), or the same seeded Ω "
                         "made up front (seeded-materialized, the bitwise oracle)")
    ap.add_argument("--k", type=int, default=None,
                    help="canonical directions (default: the configuration's)")
    ap.add_argument("--p", type=int, default=None,
                    help="oversampling (default: the configuration's; the paper ran "
                         "910 and 2000)")
    ap.add_argument("--q", type=int, default=None,
                    help="power passes (default: the configuration's)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    wl = smoke_config() if args.smoke else config()
    overrides = {f: getattr(args, f) for f in ("k", "p", "q") if getattr(args, f) is not None}
    if overrides:
        wl = dataclasses.replace(wl, rcca=dataclasses.replace(wl.rcca, **overrides))
    cfg = wl.rcca
    t0 = time.perf_counter()
    rep = fit(wl, engine=args.engine, device=args.device, seed=args.seed,
              n_chunks=args.n_chunks, omega=args.omega)
    dt = time.perf_counter() - t0
    print(f"[cca] stream mode, engine={args.engine}, omega={args.omega}, "
          f"device={args.device}, n={rep.n} ({rep.n_chunks} chunks of {wl.chunk}) "
          f"da={wl.da} db={wl.db} k={cfg.k} p={cfg.p} q={cfg.q}")
    for i, (sec, launches, (groups, host_s), sched) in enumerate(
            zip(rep.pass_seconds, rep.pass_launches, rep.pass_groups, rep.pass_schedules)):
        kind = "final" if i == cfg.q else "power"
        print(f"[cca] pass {i} ({kind}): {sec:.3f} s, schedule {sched}, kernel launches "
              f"{launches}; "
              f"merge stack: {groups} groups closed to the host, {host_s:.3f} s of the "
              "pass spent there")
    rho = rep.result.rho.double().cpu()
    print(f"[cca] done in {dt:.1f}s; sum rho = {float(rho.sum()):.4f}; "
          f"top-5 rho = {[round(float(r), 6) for r in rho[:5]]}")
    if torch.device(args.device).type == "cuda":
        rss_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        print(f"[cca] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
              f"peak host RSS {rss_kib * 1024 / 1e9:.2f} GB (closed merge groups live there)")

    if args.smoke:
        ev = evaluate(rep, wl, seed=args.seed, device=args.device)
        print("[cca] feasibility:", ev["feasibility"])
        print(f"[cca] exact-oracle objective gap: {ev['gap']:.5f} "
              f"(exact {ev['exact_sum_rho']:.4f})")
    return rep


if __name__ == "__main__":
    main()
