"""The paper's end-to-end driver: RandomizedCCA over the planted
Europarl stand-in, streamed or resident on a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.cca_fit --smoke --device cpu --engine torch
    PYTHONPATH=src python -m repro_torch.launch.cca_fit --smoke --device cpu --omega seeded
    PYTHONPATH=src python -m repro_torch.launch.cca_fit --smoke --device cpu \
        --compute-dtype bfloat16 --omega seeded
    PYTHONPATH=src python -m repro_torch.launch.cca_fit --n-chunks 4  # Europarl width, card
    PYTHONPATH=src python -m repro_torch.launch.cca_fit --p 910 --n-chunks 4
    PYTHONPATH=src python -m repro_torch.launch.cca_fit --smoke --device cpu --mode dist --ranks 4
    PYTHONPATH=src python -m repro_torch.launch.cca_fit --mode dist --ranks 2 --mesh 1,1,2 \
        --n-chunks 1 --microbatch 4096  # Europarl width, two ranks on one card
    PYTHONPATH=src python -m repro_torch.launch.cca_fit --smoke --device cpu --mode dist \
        --ranks 4 --compute-dtype bfloat16

Port of ``repro/launch/cca_fit.py``, modes ``stream`` (the port's
default; the reference defaults to ``dist``) and ``dist``.

``--mode stream``: rows are made on the device chunk by chunk
(:class:`~repro_torch.data.DevicePlantedChunks`) and streamed through
Algorithm 1's q+1 data passes
(:func:`~repro_torch.core.rcca.randomized_cca_iterator`); Ω comes from
``--seed`` under ``--omega`` (``materialized``: drawn on the device;
``seeded``: the counter-based Ω, made slab by slab inside pass 0's
kernels; ``seeded-materialized``: the same Ω made up front).
``--compute-dtype bfloat16`` runs the fit at ``RCCAConfig(dtype=bfloat16)``:
rows are made in f32 and cast to bf16 view by view, Ω is made in f32 and
cast once, and the products run the kernels' bf16 forms (seeded ones too)
with f32 accumulation and statistics, as the reference's bf16 stream
fit.

``--mode dist``: ``--ranks`` processes, laid out as ``--mesh`` (default:
the reference's greedy ``make_host_mesh`` rule), each holding its block
of the rows and features and running
:func:`~repro_torch.core.rcca_dist.dist_randomized_cca` with
``--collective``, ``--microbatch`` and ``--compute-dtype`` (the dtype the
passes cast each microbatch and Q to before the products: ``float32``,
as the reference's default, or ``bfloat16``, whose products run the
kernels' bf16 forms with f32 accumulation).  Each rank makes the same rows
and Ω as stream mode, whole, and keeps its block; ranks make them one
at a time.  On the card every rank gets ``cuda:r`` and NCCL when there
are as many cards as ranks, else they share the cards over gloo, whose
all-reduce stages CUDA tensors through the host.  The kernels are built
before the ranks start.

``--n-chunks`` cuts n to that many chunks; ``--k``, ``--p`` and ``--q``
override the configuration's (the paper ran p ∈ {910, 2000}), and
``--center`` mean-centers both views.  Prints
the wall time, kernel launches and (stream) resolved schedule of every
pass, Σρ and the top-5 ρ; dist mode also each rank's launches, seconds
in all-reduces and peak device memory.  At smoke width it also prints
the feasibility residuals and the gap to the exact dense CCA.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import math
import resource
import time
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..configs.europarl_cca import CCAWorkload, config, smoke_config
from ..core.exact import exact_cca, feasibility_errors
from ..core.rcca import (DEFAULT_ENGINE, OMEGA_MODES, RCCAResult, draw_omega,
                         randomized_cca_iterator)
from ..core.rcca_dist import COLLECTIVES, dist_randomized_cca, gather_features, shard_block
from ..data.synthetic import DevicePlantedChunks
from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels import build
from ..kernels import ops as kops
from . import ranks
from .mesh import data_axes, host_mesh_shape, model_axis


#: ``--compute-dtype``: the dtype of the products — stream mode's
#: ``RCCAConfig.dtype``, or the dtype the sharded fit's passes cast each
#: microbatch and Q to.
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def _launched(counts: dict, before: dict) -> dict:
    """Entry-point launches between two readings of the counters."""
    return {k: v - before.get(k, 0) for k, v in counts.items() if v != before.get(k, 0)}


def fit(wl: CCAWorkload, *, engine: str = DEFAULT_ENGINE, device=DEFAULT_DEVICE,
        seed: int = 0, n_chunks: int | None = None, omega: str = "materialized") -> FitReport:
    """Stream-mode fit of workload ``wl``, n cut to ``n_chunks`` chunks,
    Ω from ``seed`` under ``omega``, rows and Ω in ``wl.rcca.dtype``.
    Pass 0's interval includes making Ω (the seeded-materialized mode's
    two ``omega_fill`` launches)."""
    dev = resolve_device(device)
    cfg = wl.rcca
    n = wl.n if n_chunks is None else min(wl.n, n_chunks * wl.chunk)
    data = DevicePlantedChunks(n, wl.da, wl.db, rank=max(cfg.k * 2, 16), seed=seed,
                               chunk=wl.chunk, dtype=cfg.dtype, device=dev)
    pass_seconds, pass_launches, pass_groups = [], [], []
    _sync(dev)
    marks = {"t": time.perf_counter(), "launches": kops.launch_counts()}

    def on_pass_complete(pass_idx, kind, acc, Qa_, Qb_):
        _sync(dev)
        now, counts = time.perf_counter(), kops.launch_counts()
        pass_seconds.append(now - marks["t"])
        pass_launches.append(_launched(counts, marks["launches"]))
        pass_groups.append((acc.groups_done, acc.host_seconds))
        marks.update(t=now, launches=counts)

    res = randomized_cca_iterator(lambda: iter(data), wl.da, wl.db, cfg, seed=seed,
                                  omega=omega, engine=engine, n_chunks=data.n_chunks,
                                  on_pass_complete=on_pass_complete, device=dev)
    _sync(dev)
    return FitReport(res, n, data.n_chunks, pass_seconds, pass_launches, pass_groups,
                     res.diagnostics["schedules"])


@dataclasses.dataclass(frozen=True)
class RankSpec:
    """What one rank of a dist-mode fit runs."""

    wl: CCAWorkload
    n: int
    seed: int
    engine: str
    collective: str
    microbatch: Optional[int]
    device: str
    gather: bool
    compute_dtype: str


class DistReport(NamedTuple):
    result: RCCAResult  # ρ and λ; Xa, Xb whole when gathered, else None
    n: int
    mesh: dict  # axis → size
    backend: str
    devices: list  # each rank's device
    ranks: list  # each rank's report (:func:`dist_rank`)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def _local_data(mesh, spec: RankSpec, row_axes, col_axis, dev):
    """This rank's blocks of the Ω stream mode draws and of the rows it
    streams (the same chunks), each made whole and cut.  Ω comes first:
    its small blocks then do not land in a segment freed by a whole
    chunk, which the card could not get back."""
    wl, cfg = spec.wl, spec.wl.rcca
    Qa, Qb = draw_omega(spec.seed, wl.da, wl.db, cfg, device=dev)
    Qa_l = shard_block(Qa, mesh, col_axis, None)
    del Qa
    Qb_l = shard_block(Qb, mesh, col_axis, None)
    del Qb
    data = DevicePlantedChunks(spec.n, wl.da, wl.db, rank=max(cfg.k * 2, 16), seed=spec.seed,
                               chunk=wl.chunk, device=dev)
    rs, cs = mesh.size(row_axes), mesh.size(col_axis)
    if spec.n % rs or wl.da % cs or wl.db % cs:
        raise ValueError(f"n = {spec.n}, da = {wl.da}, db = {wl.db} do not split over "
                         f"{rs} row and {cs} feature shards")
    r0 = mesh.index(row_axes) * (spec.n // rs)
    r1 = r0 + spec.n // rs
    c = mesh.index(col_axis)
    cols_a = slice(c * (wl.da // cs), (c + 1) * (wl.da // cs))
    cols_b = slice(c * (wl.db // cs), (c + 1) * (wl.db // cs))
    parts_a, parts_b = [], []
    for idx in range(r0 // wl.chunk, (r1 - 1) // wl.chunk + 1):
        lo = idx * wl.chunk
        a, b = data.get_chunk(idx, cols_a, cols_b)
        lo_r, hi_r = max(r0 - lo, 0), min(r1 - lo, a.shape[0])
        if (lo_r, hi_r) != (0, a.shape[0]):  # a copy, not a view that keeps the chunk
            a, b = a[lo_r:hi_r].clone(), b[lo_r:hi_r].clone()
        parts_a.append(a)
        parts_b.append(b)
        del a, b
    A_l = parts_a[0] if len(parts_a) == 1 else torch.cat(parts_a)
    B_l = parts_b[0] if len(parts_b) == 1 else torch.cat(parts_b)
    del parts_a, parts_b, data
    return A_l, B_l, Qa_l, Qb_l


def dist_rank(mesh, spec: RankSpec) -> dict:
    """One rank of a dist-mode fit: make its blocks (ranks one at a time,
    behind barriers), fit, and report its compute dtype, pass times,
    launches, seconds in all-reduces, peak device memory, ρ, λ and a
    digest of its rows of Xa and Xb (and, when ``spec.gather``, the whole
    Xa and Xb)."""
    dev = resolve_device(spec.device)
    row_axes, col_axis = data_axes(mesh), model_axis(mesh)
    world = math.prod(mesh.shape.values())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for r in range(world):  # one whole view at a time on a shared card
        if r == mesh.rank:
            A_l, B_l, Qa_l, Qb_l = _local_data(mesh, spec, row_axes, col_axis, dev)
            _sync(dev)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if world > 1:
            dist.barrier()
    kops.reset_launch_counts()
    pass_seconds, pass_launches, pass_collective = [], [], []
    _sync(dev)
    marks = {"t": time.perf_counter(), "launches": {}, "coll": 0.0}

    def on_pass_complete(pass_idx, kind):
        _sync(dev)
        if dev.type == "cuda":  # other ranks may share the card: return the pass's cache
            torch.cuda.empty_cache()
        now, counts = time.perf_counter(), kops.launch_counts()
        pass_seconds.append(now - marks["t"])
        pass_launches.append(_launched(counts, marks["launches"]))
        pass_collective.append(mesh.collective_seconds - marks["coll"])
        marks.update(t=now, launches=counts, coll=mesh.collective_seconds)

    res = dist_randomized_cca(A_l, B_l, spec.wl.rcca, Qa_l, Qb_l, mesh, engine=spec.engine,
                              collective=spec.collective, microbatch=spec.microbatch,
                              compute_dtype=COMPUTE_DTYPES[spec.compute_dtype],
                              on_pass_complete=on_pass_complete, device=dev)
    del A_l, B_l, Qa_l, Qb_l
    _sync(dev)
    report = {
        "rank": mesh.rank, "coords": dict(mesh.coords), "device": str(dev),
        "compute_dtype": spec.compute_dtype,
        "pass_seconds": pass_seconds, "pass_launches": pass_launches,
        "pass_collective_seconds": pass_collective,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None,
        "rho": res.rho.double().cpu().numpy(),
        "lam_a": float(res.diagnostics["lam_a"]), "lam_b": float(res.diagnostics["lam_b"]),
        "n": res.diagnostics["n"],
        "digest": {"Xa": _digest(res.Xa), "Xb": _digest(res.Xb)},
    }
    if spec.gather:
        Xa, Xb = (gather_features(x, mesh, col_axis) for x in (res.Xa, res.Xb))
        if mesh.rank == 0:
            report.update(Xa=Xa.cpu().numpy(), Xb=Xb.cpu().numpy())
    return report


def _placement(n_ranks: int, dev: torch.device) -> tuple[str, list]:
    """(backend, each rank's device): NCCL with a card per rank, gloo
    when the ranks share cards or run on the host."""
    if dev.type == "cpu":
        return "gloo", ["cpu"] * n_ranks
    cards = torch.cuda.device_count()
    if cards >= n_ranks:
        return "nccl", [f"cuda:{r}" for r in range(n_ranks)]
    return "gloo", [f"cuda:{r % cards}" for r in range(n_ranks)]


def fit_dist(wl: CCAWorkload, *, n_ranks: int, mesh_shape=None, engine: str = DEFAULT_ENGINE,
             collective: str = "fused", microbatch: Optional[int] = None,
             device=DEFAULT_DEVICE, seed: int = 0, n_chunks: Optional[int] = None,
             gather: bool = False, compute_dtype: str = "float32",
             timeout: float = 1800.0) -> DistReport:
    """Dist-mode fit of ``wl`` on ``n_ranks`` rank processes laid out as
    ``mesh_shape`` (pod, data, model; default :func:`host_mesh_shape`),
    n cut to ``n_chunks`` chunks, Ω from ``seed``, the passes' products in
    ``compute_dtype`` (a key of :data:`COMPUTE_DTYPES`).  Builds the
    kernels first when they will run; any rank's failure raises here."""
    dev = resolve_device(device)
    shape = tuple(mesh_shape) if mesh_shape is not None else host_mesh_shape(n_ranks)
    if math.prod(shape) != n_ranks:
        raise ValueError(f"mesh {shape} does not hold {n_ranks} ranks")
    if collective not in COLLECTIVES:
        raise ValueError(f"unknown collective {collective!r}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute dtype {compute_dtype!r}")
    n = wl.n if n_chunks is None else min(wl.n, n_chunks * wl.chunk)
    if dev.type == "cuda" and engine == "kernels":
        build.build()  # the ranks load what the parent built
    backend, devices = _placement(n_ranks, dev)
    specs = [RankSpec(wl, n, seed, engine, collective, microbatch, d, gather, compute_dtype)
             for d in devices]
    (reports,) = ranks.run([ranks.Call(dist_rank, [(ranks.OnMesh(shape), s) for s in specs])],
                           n_ranks, backend=backend, devices=devices, timeout=timeout)
    r0 = reports[0]
    Xa, Xb = (torch.from_numpy(r0[k]).to(dev) if k in r0 else None for k in ("Xa", "Xb"))
    res = RCCAResult(Xa=Xa, Xb=Xb, rho=torch.from_numpy(r0["rho"]),
                     Qa=None, Qb=None,
                     diagnostics={"lam_a": r0["lam_a"], "lam_b": r0["lam_b"], "n": r0["n"]})
    return DistReport(res, n, dict(zip(("pod", "data", "model"), shape)), backend, devices,
                      reports)


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


def _print_dist(rep: DistReport, cfg) -> None:
    reports = rep.ranks
    for i, kind in enumerate(["power"] * cfg.q + ["final"]):
        secs = [round(r["pass_seconds"][i], 3) for r in reports]
        coll = [round(r["pass_collective_seconds"][i], 3) for r in reports]
        print(f"[cca] pass {i} ({kind}): {max(secs):.3f} s (per rank {secs}); kernel "
              f"launches per rank {[r['pass_launches'][i] for r in reports]}; all-reduce s "
              f"per rank {coll}")
    if reports[0]["peak_gb"] is not None:
        print(f"[cca] peak device memory per rank "
              f"{[round(r['peak_gb'], 2) for r in reports]} GB")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke width (4096 x 256/192, k=8, p=24)")
    ap.add_argument("--mode", default="stream", choices=["stream", "dist"],
                    help="stream the row chunks through one process (default), or hold "
                         "the rows resident on a mesh of rank processes (the reference's "
                         "default)")
    ap.add_argument("--device", default=DEFAULT_DEVICE, choices=["cuda", "cpu"])
    ap.add_argument("--engine", default=DEFAULT_ENGINE, choices=["kernels", "torch"],
                    help="data-pass engine: the CUDA kernels (default) or the "
                         "plain PyTorch oracle path")
    ap.add_argument("--n-chunks", type=int, default=None,
                    help="cut n to this many row chunks")
    ap.add_argument("--omega", default="materialized", choices=list(OMEGA_MODES),
                    help="Ω provenance: drawn and held (materialized), made from the "
                         "seed inside pass 0's kernels (seeded), or the same seeded Ω "
                         "made up front (seeded-materialized, the bitwise oracle); "
                         "stream mode only")
    ap.add_argument("--ranks", type=int, default=None,
                    help="dist mode: rank processes (default: the --mesh size, else 1)")
    ap.add_argument("--mesh", default=None, metavar="POD,DATA,MODEL",
                    help="dist mode: the ranks' layout (default: the reference's greedy "
                         "rule over --ranks)")
    ap.add_argument("--collective", default="fused", choices=list(COLLECTIVES),
                    help="dist mode: the model-axis sum of P between the staged kernels "
                         "(fused, fused-int8ef) or around the unfused pair")
    ap.add_argument("--microbatch", type=int, default=None,
                    help="dist mode: rows per microbatch (default: all of a rank's rows)")
    ap.add_argument("--compute-dtype", default="float32", choices=list(COMPUTE_DTYPES),
                    help="the dtype of the passes' products (bfloat16: bf16 operands, f32 "
                         "accumulation); stream mode runs RCCAConfig(dtype=...) in it")
    ap.add_argument("--gather", action="store_true",
                    help="dist mode: gather Xa, Xb over the model axis (on at --smoke)")
    ap.add_argument("--k", type=int, default=None,
                    help="canonical directions (default: the configuration's)")
    ap.add_argument("--p", type=int, default=None,
                    help="oversampling (default: the configuration's; the paper ran "
                         "910 and 2000)")
    ap.add_argument("--q", type=int, default=None,
                    help="power passes (default: the configuration's)")
    ap.add_argument("--center", action="store_true",
                    help="mean-center both views (the rank-one update of paper §3)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    wl = smoke_config() if args.smoke else config()
    overrides = {f: getattr(args, f) for f in ("k", "p", "q") if getattr(args, f) is not None}
    if args.center:
        overrides["center"] = True
    if args.mode == "stream" and args.compute_dtype != "float32":
        overrides["dtype"] = COMPUTE_DTYPES[args.compute_dtype]
    if overrides:
        wl = dataclasses.replace(wl, rcca=dataclasses.replace(wl.rcca, **overrides))
    cfg = wl.rcca
    t0 = time.perf_counter()
    if args.mode == "dist":
        if args.omega != "materialized":
            raise SystemExit("--omega applies to stream mode; dist mode draws Ω whole "
                             "(materialized) and keeps each rank's rows")
        shape = tuple(int(v) for v in args.mesh.split(",")) if args.mesh else None
        n_ranks = args.ranks or (math.prod(shape) if shape else 1)
        rep = fit_dist(wl, n_ranks=n_ranks, mesh_shape=shape, engine=args.engine,
                       collective=args.collective, microbatch=args.microbatch,
                       device=args.device, seed=args.seed, n_chunks=args.n_chunks,
                       gather=args.gather or args.smoke, compute_dtype=args.compute_dtype)
        dt = time.perf_counter() - t0
        shared = rep.devices[0] != "cpu" and len(set(rep.devices)) < len(rep.devices)
        print(f"[cca] dist mode, engine={args.engine}, collective={args.collective}, "
              f"compute_dtype={rep.ranks[0]['compute_dtype']}, "
              f"mesh={rep.mesh}, backend={rep.backend} ({n_ranks} ranks on "
              f"{sorted(set(rep.devices))}{', sharing cards' if shared else ''}), "
              f"n={rep.n} da={wl.da} db={wl.db} k={cfg.k} p={cfg.p} q={cfg.q} "
              f"microbatch={args.microbatch}")
        _print_dist(rep, cfg)
    else:
        rep = fit(wl, engine=args.engine, device=args.device, seed=args.seed,
                  n_chunks=args.n_chunks, omega=args.omega)
        dt = time.perf_counter() - t0
        print(f"[cca] stream mode, engine={args.engine}, omega={args.omega}, "
              f"compute_dtype={args.compute_dtype}, "
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
    if args.mode == "stream" and torch.device(args.device).type == "cuda":
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
