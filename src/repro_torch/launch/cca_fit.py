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
    PYTHONPATH=src python -m repro_torch.launch.cca_fit --smoke --device cpu \
        --data /tmp/s --ingest --ckpt-dir /tmp/c
    # kill it mid-pass, then:
    PYTHONPATH=src python -m repro_torch.launch.cca_fit --smoke --device cpu \
        --data /tmp/s --ckpt-dir /tmp/c --resume
    PYTHONPATH=src python -m repro_torch.launch.cca_fit --smoke --device cpu \
        --data /tmp/s --ingest --topology cluster --workers 2
    PYTHONPATH=src python -m repro_torch.launch.cca_fit --smoke --device cpu \
        --data /tmp/s --topology sharded --devices 3
    PYTHONPATH=src python -m repro_torch.launch.cca_fit --smoke --device cpu \
        --data /tmp/s --topology hybrid --workers 2 --devices-per-worker 2
    PYTHONPATH=src python -m repro_torch.launch.cca_fit --smoke --device cpu \
        --data /tmp/s --mode dist --ranks 4
    PYTHONPATH=src python -m repro_torch.launch.cca_fit --smoke --device cpu --trace /tmp/t
    PYTHONPATH=src python -m repro_torch.obs export-trace /tmp/t -o /tmp/t.json

Port of ``repro/launch/cca_fit.py``, modes ``stream`` (the port's
default; the reference defaults to ``dist``) and ``dist``.  Stream is the
default because one rank cannot hold the Europarl corpus resident (5.2 TB
in f32) and the store path below is stream mode only.

``--data STORE`` fits from an on-disk view store (``repro_torch.store``,
format-compatible with the reference's) through the prefetching
:class:`~repro_torch.store.PassRunner` (``--prefetch N``: page-locked
host chunk pairs ahead of the fold, 0 = synchronous reads, ``auto`` =
calibrated); the store's geometry overrides the workload's.  ``--ingest``
first writes there the rows the in-memory fit would stream
(``DevicePlantedChunks`` on ``--device``, cut by ``--n-chunks``, in the
compute dtype), after checking the target's free disk space.
``--ckpt-dir`` saves a pass cursor every 8 chunks; ``--resume``
continues a killed fit from the latest one, bit for bit.  Each pass
prints its IO line: read and stall seconds, rows/s, GB read, prefetch
depth.

``--topology cluster`` (or ``--workers N``) fits the store across ``N``
worker processes (default 2) through the cluster coordinator
(:mod:`repro_torch.cluster`), with its rounds, partials, cursors,
heartbeats and logs under ``--cluster-dir`` (default ``<store>.cluster``):
bitwise the Local (``--topology local``, the default) store fit.  Each
pass prints its publish, barrier, merge and boundary seconds, the bytes
of its round, partials and cursors, the launches summed over its workers,
and each worker's device, groups, seconds and peak memory.
``--topology hybrid`` gives each worker ``--devices-per-worker`` device
slots (placed by ``--devices``, ``exec.Hybrid``'s rule), and
``--topology sharded`` folds the store's merge groups one per device slot
in this process (``--devices``: a count or a list such as
``cuda:0,cuda:0``; ``exec.resolve_slots``); each pass then prints its
seconds, launches, each batch's slot device seconds and its reads.  Both
are bitwise the Local fit.

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
and Ω as stream mode, whole, and keeps its block (with ``--data``, it
reads only its rows and columns from the store instead); ranks make them
one at a time.  On the card every rank gets ``cuda:r`` and NCCL when there
are as many cards as ranks, else they share the cards over gloo, whose
all-reduce stages CUDA tensors through the host.  The kernels are built
before the ranks start.

``--trace [DIR]`` records a :mod:`repro_torch.obs` trace of the fit
(``RCCA_TRACE``, inherited by cluster workers; default directory
``rcca_trace/``): the fit, pass, io_wait and chunk spans (timed on the
card's stream as well as the host's clock), the cost model's
``kernel_cost`` and the prefetchers' ``io`` counters, the coordinator's
and workers' spans and the protocol events; the report (``python -m
repro_torch.obs report DIR``) is printed after the fit.

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
import os
import resource
import shutil
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
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
    io: Optional[dict] = None  # a store-backed fit's diagnostics["io"]
    cluster: Optional[dict] = None  # a cluster fit's diagnostics["cluster"]
    topology: Optional[dict] = None  # a sharded fit's diagnostics["topology"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launched(counts: dict, before: dict) -> dict:
    """Entry-point launches between two readings of the counters."""
    return {k: v - before.get(k, 0) for k, v in counts.items() if v != before.get(k, 0)}


def planted(wl: CCAWorkload, *, seed: int = 0, n_chunks: Optional[int] = None,
            device=DEFAULT_DEVICE) -> DevicePlantedChunks:
    """The rows a stream-mode fit of ``wl`` streams: the planted model on
    ``device`` in ``wl.rcca.dtype``, n cut to ``n_chunks`` chunks."""
    cfg = wl.rcca
    n = wl.n if n_chunks is None else min(wl.n, n_chunks * wl.chunk)
    return DevicePlantedChunks(n, wl.da, wl.db, rank=max(cfg.k * 2, 16), seed=seed,
                               chunk=wl.chunk, dtype=cfg.dtype, device=resolve_device(device))


def _existing_dir(path: str) -> str:
    d = os.path.dirname(os.path.abspath(path.rstrip("/")))
    while not os.path.exists(d):
        d = os.path.dirname(d)
    return d


def ingest(path: str, wl: CCAWorkload, *, seed: int = 0, n_chunks: Optional[int] = None,
           device=DEFAULT_DEVICE, rows_per_shard: Optional[int] = None):
    """Write :func:`planted`'s rows to a view store at ``path`` → (reader,
    seconds).  Raises ``SystemExit`` before writing when the store would
    not fit in the target's free disk space."""
    from ..dtypes import logical_name
    from ..store import ingest_planted

    data = planted(wl, seed=seed, n_chunks=n_chunks, device=device)
    need = data.n * (wl.da + wl.db) * torch.empty((), dtype=wl.rcca.dtype).element_size()
    target = _existing_dir(path)
    free = shutil.disk_usage(target).free
    if need > free:
        raise SystemExit(f"[cca] --ingest: the store needs {need / 1e9:.2f} GB, but {target} "
                         f"has {free / 1e9:.2f} GB free")
    t0 = time.perf_counter()
    reader = ingest_planted(path, data, dtype=logical_name(wl.rcca.dtype),
                            rows_per_shard=rows_per_shard)
    return reader, time.perf_counter() - t0


def fit(wl: CCAWorkload, *, engine: str = DEFAULT_ENGINE, device=DEFAULT_DEVICE,
        seed: int = 0, n_chunks: int | None = None, omega: str = "materialized",
        store=None, prefetch=2, ckpt_dir: Optional[str] = None,
        resume: bool = False, workers: int = 0,
        cluster_dir: Optional[str] = None, topology: Optional[str] = None,
        devices=None, devices_per_worker: int = 1) -> FitReport:
    """Stream-mode fit of workload ``wl``, n cut to ``n_chunks`` chunks,
    Ω from ``seed`` under ``omega``, rows and Ω in ``wl.rcca.dtype``.
    Pass 0's interval includes making Ω (the seeded-materialized mode's
    two ``omega_fill`` launches).

    With ``store`` (a ``ViewStoreReader``) the rows come from it through
    a :class:`~repro_torch.store.PassRunner` (``prefetch``, cursors in
    ``ckpt_dir``, ``resume``), and n is the store's.  With ``workers`` as
    well, the store is fitted by the cluster coordinator across that many
    worker processes (cluster directory ``cluster_dir``; ``topology=
    "hybrid"``: each worker over ``devices_per_worker`` slots placed by
    ``devices``, ``exec.Hybrid``'s rule): a pass's seconds are its wall
    time, boundary included, its launches those summed over its workers.
    ``topology="sharded"`` folds the store's merge groups one per device
    slot in this process (``devices``: ``exec.resolve_slots``), its
    ``diagnostics["topology"]`` in the report."""
    from ..exec import Cluster, Hybrid, PassEngine, Sharded
    from ..exec import fit as exec_fit
    from ..store import PassRunner

    dev = resolve_device(device)
    cfg = wl.rcca
    if topology in ("sharded", "hybrid") and store is None:
        raise ValueError(f"a {topology} fit needs a store")
    if workers:
        if store is None or cluster_dir is None:
            raise ValueError("a cluster fit needs a store and a cluster directory")
        topo = (Hybrid(workers, devices_per_worker, devices) if topology == "hybrid"
                else Cluster(workers))
        res = exec_fit(store, cfg, seed, topology=topo, engine=engine,
                       omega=omega, prefetch=prefetch, cluster_dir=cluster_dir, device=dev)
        cl = res.diagnostics["cluster"]
        passes = cl["passes"]
        return FitReport(res, store.n, store.n_chunks,
                         [p["wall_s"] + p["boundary_s"] for p in passes],
                         [p["launches"] for p in passes],
                         [(p["merge_fan_in"], p["merge_s"]) for p in passes],
                         [p["workers"][0].get("schedule") if p["workers"] else None
                          for p in passes], cluster=cl)
    data = planted(wl, seed=seed, n_chunks=n_chunks, device=dev) if store is None else None
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

    if store is None:
        res = randomized_cca_iterator(lambda: iter(data), wl.da, wl.db, cfg, seed=seed,
                                      omega=omega, engine=engine, n_chunks=data.n_chunks,
                                      on_pass_complete=on_pass_complete, device=dev)
        n, nc = data.n, data.n_chunks
    elif topology == "sharded":
        eng = PassEngine(cfg, engine=engine, omega=omega, device=dev,
                         topology=Sharded(devices=devices))
        res = eng.run_mesh(store, seed=seed, prefetch=prefetch if isinstance(prefetch, int)
                           else 2, on_pass_complete=on_pass_complete)
        n, nc = store.n, store.n_chunks
    else:
        runner = PassRunner(store, cfg, engine=engine, prefetch=prefetch, ckpt_dir=ckpt_dir,
                            omega=omega, device=dev)
        try:
            res = runner.fit(seed=seed, resume=resume, on_pass_complete=on_pass_complete)
        finally:
            runner.close()
        n, nc = store.n, store.n_chunks
    _sync(dev)
    return FitReport(res, n, nc, pass_seconds, pass_launches, pass_groups,
                     res.diagnostics["schedules"], res.diagnostics.get("io"),
                     topology=res.diagnostics.get("topology"))


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
    store: Optional[str] = None  # read the rank's rows from this view store


@dataclasses.dataclass(frozen=True)
class DistRun:
    """One fit of a dist-mode job: its mesh (pod, data, model), engine,
    collective, microbatch and compute dtype, and the view store its rows
    come from (None: made as stream mode makes them)."""

    mesh_shape: tuple
    engine: str = DEFAULT_ENGINE
    collective: str = "fused"
    microbatch: Optional[int] = None
    compute_dtype: str = "float32"
    store: Optional[str] = None


class DistReport(NamedTuple):
    result: RCCAResult  # ρ and λ; Xa, Xb whole when gathered, else None
    n: int
    mesh: dict  # axis → size
    backend: str
    devices: list  # each rank's device
    ranks: list  # each rank's report (:func:`dist_rank`)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def _store_chunks(path: str, dev):
    """``get_chunk(idx, cols_a, cols_b)`` over a view store: the chunk's
    columns read from its memory maps, as f32 on ``dev``."""
    from ..dtypes import as_tensor
    from ..store import ViewStoreReader

    reader = ViewStoreReader(path)

    def get_chunk(idx, cols_a, cols_b):
        a, b = reader.read_chunk(idx)
        return (as_tensor(np.ascontiguousarray(a[:, cols_a]), reader.dtype).to(dev, torch.float32),
                as_tensor(np.ascontiguousarray(b[:, cols_b]), reader.dtype).to(dev, torch.float32))

    return get_chunk


def _local_data(mesh, spec: RankSpec, row_axes, col_axis, dev):
    """This rank's blocks of the Ω stream mode draws and of the rows it
    streams (the same chunks), each made whole and cut, or read from
    ``spec.store`` (only the rank's rows and columns).  Ω comes first:
    its small blocks then do not land in a segment freed by a whole
    chunk, which the card could not get back."""
    wl, cfg = spec.wl, spec.wl.rcca
    Qa, Qb = draw_omega(spec.seed, wl.da, wl.db, cfg, device=dev)
    Qa_l = shard_block(Qa, mesh, col_axis, None)
    del Qa
    Qb_l = shard_block(Qb, mesh, col_axis, None)
    del Qb
    if spec.store is not None:
        get_chunk = _store_chunks(spec.store, dev)
    else:
        get_chunk = DevicePlantedChunks(spec.n, wl.da, wl.db, rank=max(cfg.k * 2, 16),
                                        seed=spec.seed, chunk=wl.chunk, device=dev).get_chunk
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
        a, b = get_chunk(idx, cols_a, cols_b)
        lo_r, hi_r = max(r0 - lo, 0), min(r1 - lo, a.shape[0])
        if (lo_r, hi_r) != (0, a.shape[0]):  # a copy, not a view that keeps the chunk
            a, b = a[lo_r:hi_r].clone(), b[lo_r:hi_r].clone()
        parts_a.append(a)
        parts_b.append(b)
        del a, b
    A_l = parts_a[0] if len(parts_a) == 1 else torch.cat(parts_a)
    B_l = parts_b[0] if len(parts_b) == 1 else torch.cat(parts_b)
    del parts_a, parts_b, get_chunk
    return A_l, B_l, Qa_l, Qb_l


def dist_rank(mesh, spec: RankSpec, job: Optional[dict] = None) -> dict:
    """One rank of a dist-mode fit: make its blocks (ranks one at a time,
    behind barriers), fit, and report its compute dtype, pass times,
    launches, seconds in all-reduces, peak device memory (data generation
    included when this fit made the blocks), ρ, λ and a digest of its rows
    of Xa and Xb (and, when ``spec.gather``, the whole Xa and Xb).

    ``job`` (``ranks.JobState``) keeps the blocks for the job's next fit:
    one on the same workload, rows, Ω, mesh and device reuses them."""
    dev = resolve_device(spec.device)
    row_axes, col_axis = data_axes(mesh), model_axis(mesh)
    world = math.prod(mesh.shape.values())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    job = {} if job is None else job
    key = (spec.wl, spec.n, spec.seed, tuple(mesh.shape.items()), mesh.rank, spec.device,
           spec.store)
    if job.get("key") != key:
        job.clear()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        for r in range(world):  # one whole view at a time on a shared card
            if r == mesh.rank:
                job.update(key=key, data=_local_data(mesh, spec, row_axes, col_axis, dev))
                _sync(dev)
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            if world > 1:
                dist.barrier()
    A_l, B_l, Qa_l, Qb_l = job["data"]
    kops.reset_launch_counts()
    pass_seconds, pass_launches, pass_collective = [], [], []
    _sync(dev)
    marks = {"t": time.perf_counter(), "launches": {}, "coll": mesh.collective_seconds}

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
             timeout: float = 1800.0, store: Optional[str] = None) -> DistReport:
    """Dist-mode fit of ``wl`` on ``n_ranks`` rank processes laid out as
    ``mesh_shape`` (pod, data, model; default :func:`host_mesh_shape`),
    n cut to ``n_chunks`` chunks, Ω from ``seed``, the passes' products in
    ``compute_dtype`` (a key of :data:`COMPUTE_DTYPES`); with ``store``
    (a view store path of ``wl``'s geometry) each rank reads its own rows
    from it.  Builds the kernels first when they will run; any rank's
    failure raises here."""
    shape = tuple(mesh_shape) if mesh_shape is not None else host_mesh_shape(n_ranks)
    run = DistRun(shape, engine, collective, microbatch, compute_dtype, store)
    return fit_dist_runs(wl, [run], n_ranks=n_ranks, device=device, seed=seed,
                         n_chunks=n_chunks, gather=gather, timeout=timeout)[0]


def fit_dist_runs(wl: CCAWorkload, runs, *, n_ranks: int, device=DEFAULT_DEVICE, seed: int = 0,
                  n_chunks: Optional[int] = None, gather: bool = False,
                  timeout: float = 1800.0) -> list:
    """Several dist-mode fits of ``wl`` (:class:`DistRun` each, every mesh
    of ``n_ranks`` ranks) in order on ONE job of rank processes: one
    spawn and rendezvous, and the ranks' rows and Ω made once for the fits
    that share a mesh (the compute dtype casts them inside the fit).
    Returns one :class:`DistReport` per run."""
    dev = resolve_device(device)
    for run in runs:
        if math.prod(run.mesh_shape) != n_ranks:
            raise ValueError(f"mesh {run.mesh_shape} does not hold {n_ranks} ranks")
        if run.collective not in COLLECTIVES:
            raise ValueError(f"unknown collective {run.collective!r}")
        if run.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute dtype {run.compute_dtype!r}")
    n = wl.n if n_chunks is None else min(wl.n, n_chunks * wl.chunk)
    if dev.type == "cuda" and any(run.engine == "kernels" for run in runs):
        build.build()  # the ranks load what the parent built
    backend, devices = _placement(n_ranks, dev)

    def rows(run) -> int:
        if run.store is None:
            return n
        from ..store import ViewStoreReader

        r = ViewStoreReader(run.store)
        if (r.da, r.db, r.chunk) != (wl.da, wl.db, wl.chunk):
            raise ValueError(f"store {run.store}: da={r.da} db={r.db} chunk={r.chunk}, the "
                             f"workload's {wl.da}, {wl.db}, {wl.chunk}")
        return r.n

    calls = [ranks.Call(dist_rank, [(ranks.OnMesh(tuple(run.mesh_shape)),
                                     RankSpec(wl, rows(run), seed, run.engine, run.collective,
                                              run.microbatch, d, gather, run.compute_dtype,
                                              run.store),
                                     ranks.JobState())
                                    for d in devices]) for run in runs]
    per_call = ranks.run(calls, n_ranks, backend=backend, devices=devices, timeout=timeout)
    out = []
    for run, reports in zip(runs, per_call):
        r0 = reports[0]
        Xa, Xb = (torch.from_numpy(r0[k]).to(dev) if k in r0 else None for k in ("Xa", "Xb"))
        res = RCCAResult(Xa=Xa, Xb=Xb, rho=torch.from_numpy(r0["rho"]), Qa=None, Qb=None,
                         diagnostics={"lam_a": r0["lam_a"], "lam_b": r0["lam_b"], "n": r0["n"]})
        out.append(DistReport(res, rows(run), dict(zip(("pod", "data", "model"), run.mesh_shape)),
                              backend, devices, reports))
    return out


def evaluate(rep: FitReport, wl: CCAWorkload, *, seed: int = 0,
             device=DEFAULT_DEVICE, rows=None) -> dict:
    """Small-scale check of a fit: materializes the rows (or takes them:
    ``rows`` = (A, B)), then the feasibility residuals and the gap of Σρ
    to the exact dense CCA."""
    cfg = wl.rcca
    if rows is None:
        rows = DevicePlantedChunks(rep.n, wl.da, wl.db, rank=max(cfg.k * 2, 16), seed=seed,
                                   chunk=wl.chunk, device=device).materialize()
    dev = resolve_device(device)
    A, B = (x.to(dev, torch.float32) for x in rows)
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


def print_io(io: dict, first_pass: int = 0) -> None:
    """A store-backed fit's IO, one line per pass, then its cursors."""
    for i, p in enumerate(io["passes"], start=first_pass):
        rate = p["rows"] / p["seconds"] if p["seconds"] else float("inf")
        print(f"[cca] pass {i} io: read {p['read_s']:.3f} s, stall {p['io_stall_s']:.3f} s, "
              f"{rate:.1f} rows/s, {p['bytes'] / 1e9:.3f} GB read ({p['gb_per_s']:.3f} GB/s "
              f"over {p['seconds']:.3f} s), prefetch depth {p['prefetch_depth']}")
    for c in io["cursors_saved"]:
        print(f"[cca] cursor saved at pass {c['pass_idx']} chunk {c['next_chunk']}: "
              f"{c['bytes'] / 1e9:.3f} GB in {c['save_s']:.3f} s")
    c = io["cursor_restored"]
    if c is not None:
        print(f"[cca] resumed from the cursor at pass {c['pass_idx']} chunk {c['next_chunk']}: "
              f"{c['bytes'] / 1e9:.3f} GB restored in {c['restore_s']:.3f} s")


def print_cluster(cl: dict) -> None:
    """A cluster fit's passes, one line each, then one line per worker."""
    for i, p in enumerate(cl["passes"]):
        print(f"[cca] pass {i} cluster: wall {p['wall_s']:.3f} s (publish {p['publish_s']:.3f}, "
              f"barrier {p['barrier_s']:.3f}, merge {p['merge_s']:.3f}), boundary "
              f"{p['boundary_s']:.3f} s; round {p['round_bytes'] / 1e9:.3f} GB, partials "
              f"{p['partial_bytes'] / 1e9:.3f} GB ({p['merge_fan_in']} merged), cursors "
              f"{p['cursor_bytes'] / 1e9:.3f} GB; launches over the workers {p['launches']}; "
              f"workers spawned {p['workers_spawned']}, groups re-dispatched "
              f"{p['redispatched_groups']}, stale heartbeats {p['stale_heartbeat_shards']}")
        for w in p["workers"]:
            peak = "not on a card" if w.get("peak_gb") is None else f"{w['peak_gb']:.2f} GB"
            print(f"[cca] pass {i} worker {w['shard']} on {w['device']}: groups {w['groups']}, "
                  f"{w['chunks']} chunks in {w['seconds']:.3f} s, schedule {w['schedule']}, "
                  f"read {w['io']['read_s']:.3f} s, stall {w['io']['io_stall_s']:.3f} s, "
                  f"peak device memory {peak}, largest host RSS {w['rss_peak_gb']:.2f} GB")


def print_sharded(rep: FitReport, cfg) -> None:
    """A sharded fit's passes, one line each: seconds, schedule, launches,
    the slots' device seconds per batch and the read-ahead's IO."""
    for i, (sec, launches, p, sched) in enumerate(zip(rep.pass_seconds, rep.pass_launches,
                                                     rep.topology["passes"],
                                                     rep.pass_schedules)):
        kind = "final" if i == cfg.q else "power"
        io = p["io"]
        dev = ("not on a card" if not p["slot_device_s"] or p["slot_device_s"][0] is None
               else [[round(x, 3) for x in b] for b in p["slot_device_s"]])
        print(f"[cca] pass {i} ({kind}): {sec:.3f} s, schedule {sched}, kernel launches "
              f"{launches}; slot device s per batch {dev}; read {io['read_s']:.3f} s, stall "
              f"{io['io_stall_s']:.3f} s, {io['bytes'] / 1e9:.3f} GB")


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
    ap.add_argument("--data", default=None, metavar="STORE",
                    help="fit from the view store at this path or URI (stream mode); its "
                         "geometry overrides the workload's")
    ap.add_argument("--ingest", action="store_true",
                    help="first write the rows the in-memory fit would stream into --data "
                         "(made on --device, cut by --n-chunks)")
    ap.add_argument("--prefetch", default="2",
                    help="store prefetch depth: page-locked host chunk pairs ahead of the "
                         "fold (0 = synchronous reads, 'auto' = calibrated)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="save a pass cursor of the store-backed fit here every 8 chunks")
    ap.add_argument("--resume", action="store_true",
                    help="continue a killed store-backed fit from the latest cursor in "
                         "--ckpt-dir")
    ap.add_argument("--topology", default=None,
                    choices=["local", "sharded", "cluster", "hybrid"],
                    help="execution topology of a store-backed fit: local = one process "
                         "(default), sharded = merge groups one per device slot in this "
                         "process, cluster = worker processes, hybrid = worker processes "
                         "each over its own device slots (all need --data but local; all "
                         "bitwise the local fit)")
    ap.add_argument("--devices", default=None,
                    help="sharded: the device slots, a count (the first N cards, N host "
                         "slots with --device cpu; default every card, one host slot) or a "
                         "list such as cuda:0,cuda:0 (slots sharing a card); hybrid: every "
                         "worker's slots, workers x devices-per-worker of them (default the "
                         "cards from w*devices-per-worker on, host slots with --device cpu)")
    ap.add_argument("--devices-per-worker", type=int, default=2,
                    help="hybrid: the device slots each worker folds its merge groups over")
    ap.add_argument("--workers", type=int, default=0,
                    help="fit the store across N worker processes through the cluster "
                         "coordinator (needs --data; default 2 under --topology cluster)")
    ap.add_argument("--cluster-dir", default=None,
                    help="the cluster's rounds, partials, cursors, heartbeats and logs "
                         "(default <store>.cluster)")
    ap.add_argument("--trace", default=None, metavar="DIR", nargs="?", const="1",
                    help="record a repro_torch.obs trace of the fit (spans and roofline "
                         "counters for every pass, chunk, worker and kernel; cluster workers "
                         "inherit it) and print its report after the fit; DIR defaults to "
                         "rcca_trace/")
    args = ap.parse_args(argv)
    if args.trace:
        os.environ[obs.TRACE_ENV] = args.trace  # before any worker is spawned
        print(f"[cca] tracing -> {obs.trace_dir()}/ (report after the fit)", flush=True)
    prefetch = args.prefetch if args.prefetch == "auto" else int(args.prefetch)

    wl = smoke_config() if args.smoke else config()
    overrides = {f: getattr(args, f) for f in ("k", "p", "q") if getattr(args, f) is not None}
    if args.center:
        overrides["center"] = True
    if args.mode == "stream" and args.compute_dtype != "float32":
        overrides["dtype"] = COMPUTE_DTYPES[args.compute_dtype]
    if overrides:
        wl = dataclasses.replace(wl, rcca=dataclasses.replace(wl.rcca, **overrides))
    if args.mode == "dist" and (args.topology not in (None, "local") or args.workers
                                or args.ckpt_dir or args.resume):
        raise SystemExit("--mode dist holds each rank's rows resident (--data: read from the "
                         "store); --topology, --workers, --ckpt-dir and --resume are stream "
                         "mode only")
    if not args.data and (args.ingest or args.ckpt_dir or args.resume):
        raise SystemExit("--ingest, --ckpt-dir and --resume need a store: pass --data")
    if args.topology is None and args.workers:
        args.topology = "cluster"
    cluster = args.topology in ("cluster", "hybrid")
    sharded = args.topology == "sharded"
    if (cluster or sharded) and not args.data:
        raise SystemExit(f"--topology {args.topology} needs an on-disk store: pass --data (it "
                         "cuts a view store into merge groups)")
    if args.workers and not args.data:
        raise SystemExit("--workers needs an on-disk store: pass --data (the cluster "
                         "coordinator shards a view store)")
    if (cluster or sharded) and (args.ckpt_dir or args.resume):
        raise SystemExit("--ckpt-dir and --resume are the local fit's cursors; cluster "
                         "workers keep theirs under --cluster-dir, and a device-parallel "
                         "pass restarts whole")
    if args.devices is not None and not (cluster or sharded):
        raise SystemExit("--devices places the slots of --topology sharded or hybrid")
    reader = None
    if args.data:
        from ..store import ViewStoreReader, store_exists

        if args.ingest or not store_exists(args.data):
            reader, secs = ingest(args.data, wl, seed=args.seed, n_chunks=args.n_chunks,
                                  device=args.device)
            print(f"[cca] ingested {reader.n} rows ({reader.nbytes / 1e9:.3f} GB, "
                  f"{len(reader.shards)} shards, {reader.dtype}) -> {args.data} in {secs:.2f} s "
                  f"({reader.nbytes / secs / 1e9:.3f} GB/s)")
        else:
            reader = ViewStoreReader(args.data)
            print(f"[cca] view store {args.data}: n={reader.n} da={reader.da} db={reader.db} "
                  f"chunk={reader.chunk} {reader.dtype} ({reader.nbytes / 1e9:.3f} GB)")
        geometry = (reader.n, reader.da, reader.db, reader.chunk)
        if geometry != (wl.n, wl.da, wl.db, wl.chunk):
            print(f"[cca] store geometry overrides the workload: n={reader.n} da={reader.da} "
                  f"db={reader.db} chunk={reader.chunk}")
            wl = dataclasses.replace(wl, n=reader.n, da=reader.da, db=reader.db,
                                     chunk=reader.chunk)
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
                       gather=args.gather or args.smoke, compute_dtype=args.compute_dtype,
                       store=args.data)
        dt = time.perf_counter() - t0
        shared = rep.devices[0] != "cpu" and len(set(rep.devices)) < len(rep.devices)
        print(f"[cca] dist mode, engine={args.engine}, collective={args.collective}, "
              f"compute_dtype={rep.ranks[0]['compute_dtype']}, "
              f"mesh={rep.mesh}, backend={rep.backend} ({n_ranks} ranks on "
              f"{sorted(set(rep.devices))}{', sharing cards' if shared else ''}), "
              f"n={rep.n} da={wl.da} db={wl.db} k={cfg.k} p={cfg.p} q={cfg.q} "
              f"microbatch={args.microbatch}"
              f"{', rows read by each rank from ' + args.data if args.data else ''}")
        _print_dist(rep, cfg)
    elif cluster:
        workers = args.workers or 2
        cluster_dir = args.cluster_dir or args.data.rstrip("/") + ".cluster"
        if prefetch == "auto":
            print("[cca] --prefetch auto is a one-process calibration; cluster workers use "
                  "depth 2")
            prefetch = 2
        dpw = args.devices_per_worker if args.topology == "hybrid" else 1
        rep = fit(wl, engine=args.engine, device=args.device, seed=args.seed,
                  omega=args.omega, store=reader, prefetch=prefetch, workers=workers,
                  cluster_dir=cluster_dir, topology=args.topology, devices=args.devices,
                  devices_per_worker=dpw)
        dt = time.perf_counter() - t0
        slots = f" x {dpw} slots {rep.cluster['worker_slots']}" if dpw > 1 else ""
        print(f"[cca] {args.topology} topology, engine={args.engine}, omega={args.omega}, "
              f"compute_dtype={args.compute_dtype}, device={args.device}, workers={workers}"
              f"{slots}, "
              f"n={rep.n} ({rep.n_chunks} chunks of {wl.chunk}, {rep.cluster['n_groups']} "
              f"merge groups) da={wl.da} db={wl.db} k={cfg.k} p={cfg.p} q={cfg.q}, "
              f"cluster_dir={cluster_dir}")
        print_cluster(rep.cluster)
    elif sharded:
        if prefetch == "auto":
            print("[cca] --prefetch auto is a one-process calibration; the slots use depth 2")
            prefetch = 2
        rep = fit(wl, engine=args.engine, device=args.device, seed=args.seed,
                  omega=args.omega, store=reader, prefetch=prefetch, topology="sharded",
                  devices=args.devices)
        dt = time.perf_counter() - t0
        topo = rep.topology
        print(f"[cca] sharded topology, engine={args.engine}, omega={args.omega}, "
              f"compute_dtype={args.compute_dtype}, slots {topo['slots']}, n={rep.n} "
              f"({rep.n_chunks} chunks of {wl.chunk}, {topo['n_groups']} merge groups of "
              f"{topo['merge_group']}) da={wl.da} db={wl.db} k={cfg.k} p={cfg.p} q={cfg.q}")
        print_sharded(rep, cfg)
    else:
        rep = fit(wl, engine=args.engine, device=args.device, seed=args.seed,
                  n_chunks=args.n_chunks, omega=args.omega, store=reader,
                  prefetch=prefetch, ckpt_dir=args.ckpt_dir, resume=args.resume)
        dt = time.perf_counter() - t0
        print(f"[cca] stream mode{' (store-backed)' if reader else ''}, engine={args.engine}, "
              f"omega={args.omega}, compute_dtype={args.compute_dtype}, "
              f"device={args.device}, n={rep.n} ({rep.n_chunks} chunks of {wl.chunk}) "
              f"da={wl.da} db={wl.db} k={cfg.k} p={cfg.p} q={cfg.q}")
        first = cfg.q + 1 - len(rep.pass_seconds)  # a resumed fit skips passes
        for i, (sec, launches, (groups, host_s), sched) in enumerate(
                zip(rep.pass_seconds, rep.pass_launches, rep.pass_groups, rep.pass_schedules),
                start=first):
            kind = "final" if i == cfg.q else "power"
            print(f"[cca] pass {i} ({kind}): {sec:.3f} s, schedule {sched}, kernel launches "
                  f"{launches}; "
                  f"merge stack: {groups} groups closed to the host, {host_s:.3f} s of the "
                  "pass spent there")
        if rep.io is not None:
            print_io(rep.io, first)
    rho = rep.result.rho.double().cpu()
    print(f"[cca] done in {dt:.1f}s; sum rho = {float(rho.sum()):.4f}; "
          f"top-5 rho = {[round(float(r), 6) for r in rho[:5]]}")
    if args.mode == "stream" and not cluster and torch.device(args.device).type == "cuda":
        # a sharded fit's slots may sit on other cards: this is the current card's peak
        rss_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        print(f"[cca] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
              f"peak host RSS {rss_kib * 1024 / 1e9:.2f} GB (closed merge groups live there)")
    if args.trace:
        from ..obs import report as obs_report

        print(obs_report.render(obs_report.analyze(obs.trace_dir())), flush=True)

    if args.smoke:
        rows = None
        if reader is not None:
            if reader.nbytes > 2 << 30:
                print("[cca] store larger than the evaluation budget: no exact-oracle check")
                return rep
            rows = reader.materialize()
        ev = evaluate(rep, wl, seed=args.seed, device=args.device, rows=rows)
        print("[cca] feasibility:", ev["feasibility"])
        print(f"[cca] exact-oracle objective gap: {ev['gap']:.5f} "
              f"(exact {ev['exact_sum_rho']:.4f})")
    return rep


if __name__ == "__main__":
    main()
