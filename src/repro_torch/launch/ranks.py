"""Run functions on a job of fresh rank processes.

:func:`run` spawns one process per rank (``torch.multiprocessing``, the
``spawn`` start method), joins them into one ``torch.distributed`` job
through a ``FileStore`` in a new temporary directory (never a fixed TCP
port, so jobs started side by side do not meet), runs a list of calls on
every rank, and returns what each rank returned.  A :class:`OnMesh`
argument stands for the :class:`~repro_torch.launch.mesh.Mesh` of that
shape on the rank that runs the call.

A rank that raises fails the job: the parent raises with that rank's
traceback and kills the others.  So does a rank that dies, and the job
as a whole has a time limit, also passed to the process group, so a hung
collective ends in an error and not a hang.  The called functions must
be importable by module path (``spawn`` pickles them by name); their
arguments are pickled by value (CPU tensors, numpy arrays, plain
values) into one file per rank in the job's directory, which the rank
reads once it has started (through the start pipe, a payload larger than
the pipe would hold each start until the rank before it had imported
its modules).  Results come back as numpy arrays and plain values.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import AXES, Mesh


@dataclasses.dataclass(frozen=True)
class OnMesh:
    """In a call's arguments: the mesh of ``shape`` over the job's ranks."""

    shape: tuple
    axes: tuple = AXES


@dataclasses.dataclass(frozen=True)
class Call:
    """``fn(*args[rank], **kwargs)`` on every rank."""

    fn: Callable
    args: Sequence[tuple]
    kwargs: dict = dataclasses.field(default_factory=dict)


def _to_host(x):
    """Tensors → numpy, recursively through tuples, lists and dicts."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _rank_main(rank: int, world: int, job_dir: str, backend: str, device: str,
               timeout: float, out) -> None:
    meshes: dict = {}

    def resolve(v):
        if isinstance(v, OnMesh):
            key = (tuple(v.shape), tuple(v.axes))
            if key not in meshes:
                meshes[key] = Mesh(v.shape, v.axes)
            return meshes[key]
        return v

    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            # ranks may share a card: let the allocator hand freed pages back
            os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        with open(os.path.join(job_dir, f"calls-{rank}.pkl"), "rb") as f:
            calls = pickle.load(f)  # written by run() for this job
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(job_dir, "store"),
                                                              world),
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        results = []
        for fn, args, kwargs in calls:
            args = [resolve(v) for v in args]
            kwargs = {k: resolve(v) for k, v in kwargs.items()}
            results.append(_to_host(fn(*args, **kwargs)))
        out.put(("ok", rank, results))
    except BaseException:
        out.put(("error", rank, traceback.format_exc()))
        raise SystemExit(1) from None
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(calls: Sequence[Call], world: int, *, backend: str = "gloo",
        devices: Optional[Sequence[str]] = None, timeout: float = 600.0) -> list:
    """Run ``calls`` in order on ``world`` new rank processes; returns,
    per call, the list of the ranks' results.  ``devices[r]`` is rank r's
    device (default: all on the CPU)."""
    devices = list(devices) if devices is not None else ["cpu"] * world
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    for c in calls:
        if len(c.args) != world:
            raise ValueError(f"{c.fn.__name__}: {len(c.args)} argument tuples for {world} ranks")
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        for r in range(world):
            with open(os.path.join(tmp, f"calls-{r}.pkl"), "wb") as f:
                pickle.dump([(c.fn, c.args[r], c.kwargs) for c in calls], f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, tmp, backend, devices[r], timeout, out))
                 for r in range(world)]
        try:
            for p in procs:
                p.start()
            results: list = [None] * world
            pending = set(range(world))
            while pending:
                try:
                    kind, r, payload = out.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [(r, procs[r].exitcode) for r in sorted(pending)
                            if procs[r].exitcode is not None]
                    if dead:
                        raise RuntimeError(f"rank {dead[0][0]} exited with code "
                                           f"{dead[0][1]} and no result") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"ranks {sorted(pending)} still running after "
                                           f"{timeout:.0f} s") from None
                    continue
                if kind == "error":
                    raise RuntimeError(f"rank {r} failed:\n{payload}")
                results[r] = payload
                pending.discard(r)
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
                if p.exitcode != 0:
                    raise RuntimeError(f"a rank exited with code {p.exitcode}")
        finally:
            for p in procs:
                if p.pid is None:
                    continue  # never started
                if p.is_alive():
                    p.kill()
                p.join()
    return [[results[r][i] for r in range(world)] for i in range(len(calls))]
