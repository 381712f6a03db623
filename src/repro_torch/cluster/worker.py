"""One shard of one data pass: the cluster's map task.

    PYTHONPATH=src python -m repro_torch.cluster.worker --store /data/corpus \
        --cluster-dir /data/cluster --shard 3 --n-shards 8 --pass-idx 0 [--device cpu]

Port of ``repro/cluster/worker.py``.  Any scheduler may run it: beyond
its shard identity, everything a worker needs comes from the store's
manifest and the pass's ROUND
(:mod:`repro_torch.cluster.partials`): the Qa/Qb bases (under
``omega="seeded"``, pass 0's per-view seeds: the kernels engine makes Ω
on the card inside the seeded stage, the torch engine makes it from the
seed), the engine, the merge-group size and the binding metadata.  It
runs on ``--device`` (the card by default; a worker that cannot reach
CUDA, or build or load the kernels, fails and folds nothing).

The worker takes its merge groups, striped in runs of ``combine`` groups
(``store.shard_chunks``), streams their chunks through the store's
prefetcher onto the device and folds each group through the one
canonical fold (``exec.run_fold`` into a sink-mode
``SegmentedAccumulator``) with the Local fit's per-chunk updates, so a
group's sum is the Local fit's bits: the same kernels at the same chunk
shapes, resolving the same schedules.  Each closed group is published
as a partial, or first pre-merged with its run into aligned spans
(``exec.SpanCombiner``) when the round asks for ``combine > 1``.  The
store's look-ahead rule takes 1/n-shards of the card's free memory.

``--devices`` above one slot (a count, or a slot list such as
``cuda:0,cuda:0``: ``exec.resolve_slots``) makes the Hybrid topology's
worker: its groups are folded one per slot, each on its slot's stream
(``exec.fold_groups_on_mesh``, the same updates, so the same bits), and
published in ascending order through the same combiner.  Its cursors
are at group granularity (a killed Hybrid worker's published groups are
skipped, the others redone) and kill and hang injection act after the
group that holds the chunk named.  The look-ahead rule's share is
n-shards × the worker's slots on the card.

Fault tolerance:

- a CURSOR (the open group and the next chunk) is saved every
  ``ckpt_every`` chunks and at each group's close, so a killed worker
  re-run with the same shard id resumes mid-group; published groups are
  skipped, the open one continues from the cursor, and the store is
  never read again for the folded prefix.  A cursor saved at a group's
  close holds no tensor: the group is in its partial;
- partials already published (by an earlier run, or by a repair worker
  that took the shard over) are found by their binding and skipped:
  publishing is idempotent, since a partial is a deterministic function
  of the store, the round and the group;
- a HEARTBEAT beacon is touched at start and at every group close and
  cursor save; the coordinator re-dispatches a shard whose beacon goes
  stale (a worker that hangs) before the pass's time limit.

``RCCA_CLUSTER_KILL_AT=<pass>:<chunk>`` simulates a crash right after
folding that chunk: the CLI dies by ``os._exit``, skipping every
clean-up, as a lost machine would.  ``RCCA_CLUSTER_HANG_AT=<pass>:<chunk>``
wedges the worker in a sleep loop there (the beacon goes stale, the
process stays alive).

Under ``RCCA_TRACE`` (inherited from the coordinator) the worker's
records carry its role ``worker<shard>``: a ``worker_pass`` span around
its fold, the fold's ``io_wait`` and ``chunk`` spans with their cost,
a ``publish`` span per partial, the ``kernel_cost`` and ``io``
counters, and the partial store's protocol events.  Under
``RCCA_SANITIZE=1`` (inherited the same way) it fingerprints each merge
group's sum as it leaves the worker (``group:g``, site ``worker``).

The CLI prints one line ``[worker] report {json}`` at the end: the fit
id, shard, pass, device, schedule, groups folded and published, chunks,
bytes of partials and cursors, seconds, IO, kernel launches, the peak
device memory and the largest host RSS seen at a chunk or publication,
and the sanitizer's trace when it is on; the coordinator reads it from
the log.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Optional, Sequence

import torch

from .. import obs
from ..analysis import sanitize
from ..ckpt import CheckpointManager
from ..obs.cost import chunk_cost_fn
from ..core.rcca import (RCCAConfig, seeded_update_fn, stats_init_fn, stats_like,
                         update_fn)
from ..device import DEFAULT_DEVICE
from ..dtypes import torch_dtype
from ..exec import (SegmentedAccumulator, SpanCombiner, fold_groups_on_mesh, resolve_slots,
                    run_fold)
from ..kernels import build
from ..kernels import ops as kops
from ..kernels import rand as krand
from ..store import ViewStoreReader, prefetched, shard_chunks
from ..store.passes import residency, residency_line
from ..store.prefetch import DeviceStaging, HostSlots, HostStaging
from . import partials as pt

KILL_ENV = "RCCA_CLUSTER_KILL_AT"
HANG_ENV = "RCCA_CLUSTER_HANG_AT"
REPORT = "[worker] report "

#: Chunks folded between two waits for the card: bounds the work queued
#: ahead of it, as the Local fit's ``sync_chunks``.
SYNC_CHUNKS = 4


class WorkerKilled(RuntimeError):
    """An injected crash (:data:`KILL_ENV`)."""


def _parse_injection(env: str, pass_idx: int) -> Optional[int]:
    spec = os.environ.get(env)
    if not spec:
        return None
    p, _, c = spec.partition(":")
    return int(c) if int(p) == pass_idx else None


def _hang_forever(shard: int, chunk_idx: int) -> None:
    print(f"[worker {shard}] injected hang at chunk {chunk_idx}", flush=True)
    while True:  # alive, but no beats and no exit
        time.sleep(0.5)


def _config(algo: dict) -> RCCAConfig:
    return RCCAConfig(k=int(algo["k"]), p=int(algo["p"]), q=int(algo["q"]),
                      lam_a=algo["lam_a"], lam_b=algo["lam_b"], nu=algo["nu"],
                      center=algo["center"], dtype=torch_dtype(algo["dtype"]))


def rss_gb() -> float:
    """This process's resident set now (``VmRSS``), GB; 0 where the
    kernel does not report it."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    return 0.0


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"cuda:{dev.index if dev.index is not None else torch.cuda.current_device()}"
    return "cpu"


def run_worker(store: str, cluster_dir: str, shard: int, n_shards: int, pass_idx: int, *,
               groups: Optional[Sequence[int]] = None, prefetch: int = 2,
               ckpt_every: int = 4, round_wait_s: float = 30.0,
               kill_at_chunk: Optional[int] = None, device=DEFAULT_DEVICE,
               devices=1, report: Optional[dict] = None) -> int:
    """Process one shard of one pass on ``device``; returns the number of
    partials this run published (0 when every owned group was already
    published).  ``groups`` overrides the striped assignment (the
    coordinator's re-dispatch); ``kill_at_chunk`` injects a crash as
    :data:`KILL_ENV` does; ``devices`` are the worker's slots
    (``exec.resolve_slots`` on ``device``'s kind: more than one makes a
    Hybrid worker).  ``report``, when given, is filled with what
    the CLI prints."""
    t_start = obs.monotonic()
    slots = resolve_slots(devices, device)
    dev = slots[0]
    reader = ViewStoreReader(store)
    pt.touch_heartbeat(cluster_dir, shard, pass_idx)  # alive while it waits for the round
    Qa, Qb, meta = pt.read_round(cluster_dir, pass_idx, wait_s=round_wait_s)
    if meta["fingerprint"] != reader.fingerprint():
        raise ValueError(f"round for pass {pass_idx} was published against a different store "
                         f"(fingerprint {meta['fingerprint'][:12]}… != "
                         f"{reader.fingerprint()[:12]}…)")
    if kill_at_chunk is None:
        kill_at_chunk = _parse_injection(KILL_ENV, pass_idx)
    hang_at_chunk = _parse_injection(HANG_ENV, pass_idx)

    kind, engine = meta["kind"], meta["engine"]
    obs.set_context(fit_id=meta.get("fit_id"), role=f"worker{shard:03d}", shard=shard)
    sanitize.reset()
    sanitize.set_context(pass_idx=int(pass_idx), kind=kind, site="worker")
    cfg = _config(meta["algo"])
    kt, G, n_chunks = cfg.sketch, int(meta["merge_group"]), reader.n_chunks
    n_groups = -(-n_chunks // G)
    if dev.type == "cuda" and engine == "kernels":
        build.build()  # fails here, before any fold, when the kernels cannot load
    seeded = meta.get("omega") == "seeded" and pass_idx == 0
    if seeded and engine != "kernels":  # the torch engine makes Ω from the seed
        Qa = krand.dense_omega(Qa, reader.da, kt, cfg.dtype, device=dev)
        Qb = krand.dense_omega(Qb, reader.db, kt, cfg.dtype, device=dev)
        seeded = False
    elif not seeded:
        Qa, Qb = (q.to(dev).contiguous() for q in (Qa, Qb))
    init_fn = stats_init_fn(kind, reader.da, reader.db, kt, dev)
    upd = seeded_update_fn(kind, kt) if seeded else update_fn(kind, engine)
    pt.touch_heartbeat(cluster_dir, shard, pass_idx)

    expect = {k: meta.get(k) for k in pt.BINDING_KEYS}
    combine = int(meta.get("combine", 1))
    if groups is None:
        owned = [g for g in range(n_groups) if (g // combine) % n_shards == shard]
    else:
        owned = sorted(int(g) for g in groups)

    def group_done(g: int) -> bool:
        """Published already, alone or inside any aligned span that holds g."""
        s = 1
        while s <= combine:
            if pt.binding_matches(pt.partial_meta(cluster_dir, pass_idx, g - g % s, s), expect):
                return True
            s <<= 1
        return False

    todo = [g for g in owned if not group_done(g)]
    state = {"published": 0, "partial_bytes": 0, "chunks": 0, "cursor_bytes": [],
             "schedule": None, "rss_gb": rss_gb()}
    launches0 = kops.launch_counts()
    if report is not None:
        report.update(fit_id=meta.get("fit_id"), shard=shard, pass_idx=pass_idx, kind=kind,
                      engine=engine, device=_device_name(dev), groups=todo, published=0,
                      chunks=0)
    if not todo:
        return 0

    def publish_span(g: int, span: int, stats) -> None:
        """The group (or span) sink: publish if new, count, beat."""
        with obs.span("publish", group=int(g), span=int(span)):
            if not pt.binding_matches(pt.partial_meta(cluster_dir, pass_idx, g, span), expect):
                state["partial_bytes"] += pt.write_partial(cluster_dir, pass_idx, g, stats,
                                                           expect, shard=shard,
                                                           n_shards=n_shards, span=span)
            state["published"] += 1
            state["rss_gb"] = max(state["rss_gb"], rss_gb())
            pt.touch_heartbeat(cluster_dir, shard, pass_idx)

    combiner = SpanCombiner(combine, publish_span)

    def publish(g: int, stats) -> None:
        if sanitize.enabled():  # the group's sum as it leaves the worker
            sanitize.observe(f"group:{g}", stats)
        if combine > 1:
            combiner.emit(g, stats)
        else:
            publish_span(g, 1, stats)

    if len(slots) > 1:
        return _hybrid_pass(reader, cfg, slots, todo, upd, Qa, Qb, publish, combiner, state,
                            group=G, kind=kind, engine=engine, seeded=seeded,
                            pass_idx=pass_idx, shard=shard, n_shards=n_shards,
                            prefetch=prefetch, kill_at_chunk=kill_at_chunk,
                            hang_at_chunk=hang_at_chunk, launches0=launches0, t_start=t_start,
                            report=report)

    # resume position: a cursor of this fit, mid-way through the first group
    # still missing its partial; anything else is redone from the group's start
    cursor_dir = pt.worker_cursor_dir(cluster_dir, shard, pass_idx)
    mgr = CheckpointManager(cursor_dir, keep=2)
    cur_meta = mgr.metadata()
    start_chunk, current = todo[0] * G, None
    if cur_meta is not None and not pt.binding_matches(cur_meta, expect):
        shutil.rmtree(cursor_dir)  # an earlier fit's: its steps would outlive ours
        mgr = CheckpointManager(cursor_dir, keep=2)
    elif cur_meta is not None and cur_meta.get("shard") == shard:
        nxt, g0 = int(cur_meta["next_chunk"]), int(cur_meta["group"])
        if todo[0] == g0 and g0 * G < nxt < min(n_chunks, (g0 + 1) * G):
            like = stats_like(kind, reader.da, reader.db, kt)
            tree, _ = mgr.restore({"current": like})
            current = type(like)(*(t.to(dev) for t in tree["current"]))
            start_chunk = nxt

    todo_set = set(todo)
    if groups is None:  # striped in G·combine-chunk runs: whole combine runs per worker
        idxs = [c for c in shard_chunks(shard, n_shards, n_chunks, start=start_chunk,
                                        group=G * combine) if c // G in todo_set]
    else:
        idxs = [c for g in todo for c in range(g * G, min(n_chunks, (g + 1) * G))
                if c >= start_chunk]

    rule = slots = None
    if dev.type == "cuda":
        rule = residency(reader, cfg, dev, prefetch, share=n_shards)
        print(residency_line(rule), flush=True)
        slots = HostSlots(reader.chunk, reader.da, reader.db, reader.torch_dtype)
        slots.ensure(max(1, min(prefetch, rule["host_slots"])))
        staging = DeviceStaging(dev, slots, lookahead=rule["lookahead"])
        depth = min(prefetch, rule["host_slots"])
    else:
        staging, depth = HostStaging(reader.dtype), prefetch
    src = prefetched((reader.read_chunk(i) for i in idxs), depth=depth, staging=staging,
                     site=f"worker{shard}")

    def on_device(x) -> torch.Tensor:
        return torch.as_tensor(x, device=dev, dtype=cfg.dtype).contiguous()

    def indexed():
        """(chunk, (a, b)) on the device, holding no chunk while the
        prefetcher makes the next one."""
        it = iter(src)
        for i in idxs:
            ab = next(it)
            pair = (on_device(ab[0]), on_device(ab[1]))
            del ab
            if state["schedule"] is None:
                state["schedule"] = kops.chunk_cost(
                    kind, int(pair[0].shape[0]), reader.da, reader.db, kt, engine=engine,
                    seeded=seeded, dtype=cfg.dtype)["schedule"]
            yield i, pair
            del pair

    since_cursor = [0]

    def cb(chunk_idx: int, acc: SegmentedAccumulator) -> None:
        state["chunks"] += 1
        state["rss_gb"] = max(state["rss_gb"], rss_gb())
        since_cursor[0] += 1
        if dev.type == "cuda" and state["chunks"] % SYNC_CHUNKS == 0:
            torch.cuda.current_stream(dev).synchronize()
        end_of_group = (chunk_idx + 1) % G == 0 or chunk_idx + 1 == n_chunks
        if since_cursor[0] % ckpt_every == 0 or end_of_group:
            nbytes = mgr.save(chunk_idx, {"current": acc.current},
                              metadata={**expect, "next_chunk": chunk_idx + 1,
                                        "group": (chunk_idx + 1) // G, "shard": shard})
            state["cursor_bytes"].append(nbytes)
            pt.touch_heartbeat(cluster_dir, shard, pass_idx)
        if hang_at_chunk is not None and chunk_idx >= hang_at_chunk:
            _hang_forever(shard, chunk_idx)
        if kill_at_chunk is not None and chunk_idx >= kill_at_chunk:
            raise WorkerKilled(f"injected kill at chunk {chunk_idx}")

    acc = SegmentedAccumulator(init_fn, n_chunks, G, sink=publish)
    if current is not None:
        acc.resume_group(current, start_chunk)
    cost_fn = chunk_cost_fn(kind, engine, kt, cfg.dtype, seeded=seeded)  # None untraced
    try:
        with obs.span("worker_pass", pass_idx=int(pass_idx), kind=kind, shard=shard,
                      site="worker"):
            run_fold(indexed(), upd, acc, Qa, Qb, on_chunk=cb, device=dev, cost_fn=cost_fn,
                     span_attrs={"kind": kind, "engine": engine, "pass_idx": int(pass_idx)})
            combiner.flush()  # the trailing short run (end of stream)
    finally:
        combiner.close()
        try:
            src.close()
        finally:
            staging.close()
            if slots is not None:
                slots.close()
    if report is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        counts = kops.launch_counts()
        report.update(
            published=state["published"], chunks=state["chunks"],
            partial_bytes=state["partial_bytes"], cursor_bytes=state["cursor_bytes"],
            schedule=state["schedule"], resumed_at=start_chunk if current is not None else None,
            io=src.stats(), residency=rule, seconds=round(obs.monotonic() - t_start, 4),
            rss_peak_gb=state["rss_gb"],
            launches={k: v - launches0.get(k, 0) for k, v in counts.items()
                      if v != launches0.get(k, 0)})
    return state["published"]


def _hybrid_pass(reader, cfg, slots, todo, upd, Qa, Qb, publish, combiner, state, *, group,
                 kind, engine, seeded, pass_idx, shard, n_shards, prefetch, kill_at_chunk,
                 hang_at_chunk, launches0, t_start, report) -> int:
    """A Hybrid worker's pass: its groups ``todo`` folded one per slot
    (``exec.fold_groups_on_mesh``) and published in ascending order;
    kill and hang injection after the group that holds the chunk named.
    Returns the partials published."""
    from ..store.passes import SlotSet

    G, n_chunks, kt = group, reader.n_chunks, cfg.sketch
    first = todo[0] * G
    rows = min(reader.chunk, reader.n - first * reader.chunk)
    state["schedule"] = kops.chunk_cost(kind, rows, reader.da, reader.db, kt, engine=engine,
                                        seeded=seeded, dtype=cfg.dtype)["schedule"]

    def emit(g: int, stats) -> None:
        last = min(n_chunks, (g + 1) * G) - 1
        publish(g, stats)
        state["chunks"] += last + 1 - g * G
        state["rss_gb"] = max(state["rss_gb"], rss_gb())
        if hang_at_chunk is not None and last >= hang_at_chunk:
            _hang_forever(shard, last)
        if kill_at_chunk is not None and last >= kill_at_chunk:
            raise WorkerKilled(f"injected kill after group {g} (chunk {last})")

    mesh = SlotSet(reader, cfg, slots, prefetch=prefetch, share=n_shards)
    try:
        with obs.span("worker_pass", pass_idx=int(pass_idx), kind=kind, shard=shard,
                      site="hybrid"):
            device_s = fold_groups_on_mesh(
                reader, todo, upd,
                lambda d: stats_init_fn(kind, reader.da, reader.db, kt, d), Qa, Qb,
                slots=mesh, merge_group=G, n_chunks=n_chunks, emit=emit, dtype=cfg.dtype,
                span_attrs={"kind": kind, "engine": engine, "pass_idx": int(pass_idx)},
                cost_fn=chunk_cost_fn(kind, engine, kt, cfg.dtype, seeded=seeded))
            combiner.flush()  # the trailing short run (end of stream)
    finally:
        combiner.close()
        mesh.close()
    if report is not None:
        for d in dict.fromkeys(mesh.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        counts = kops.launch_counts()
        report.update(
            published=state["published"], chunks=state["chunks"],
            partial_bytes=state["partial_bytes"], cursor_bytes=[], schedule=state["schedule"],
            resumed_at=None, io=mesh.io[-1], residency=next(iter(mesh.rules.values()), None),
            slots=[_device_name(d) for d in mesh.devices], slot_device_s=device_s,
            seconds=round(obs.monotonic() - t_start, 4), rss_peak_gb=state["rss_gb"],
            launches={k: v - launches0.get(k, 0) for k, v in counts.items()
                      if v != launches0.get(k, 0)})
    return state["published"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--store", required=True, help="view store path or URI")
    ap.add_argument("--cluster-dir", required=True)
    ap.add_argument("--shard", type=int, required=True)
    ap.add_argument("--n-shards", type=int, required=True)
    ap.add_argument("--pass-idx", type=int, required=True)
    ap.add_argument("--groups", default=None,
                    help="comma-separated merge groups overriding the striped assignment "
                         "(the coordinator's re-dispatch)")
    ap.add_argument("--devices", default="1",
                    help="the worker's device slots: a count (the first N cards, or N host "
                         "slots with --device cpu) or a list such as cuda:0,cuda:0; more "
                         "than one folds the merge groups one per slot (the hybrid topology)")
    ap.add_argument("--device", default=DEFAULT_DEVICE, choices=["cuda", "cpu"])
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--ckpt-every", type=int, default=4)
    ap.add_argument("--round-wait-s", type=float, default=30.0)
    args = ap.parse_args(argv)
    groups = [int(g) for g in args.groups.split(",")] if args.groups else None
    report: dict = {}
    try:
        n = run_worker(args.store, args.cluster_dir, args.shard, args.n_shards, args.pass_idx,
                       groups=groups, prefetch=args.prefetch, ckpt_every=args.ckpt_every,
                       round_wait_s=args.round_wait_s, device=args.device, devices=args.devices,
                       report=report)
    except WorkerKilled as e:
        print(f"[worker {args.shard}] {e}", flush=True)
        os._exit(3)  # a hard death: no clean-up, like a lost machine
    cards = {torch.device(d) for d in report.get("slots", [report.get("device", args.device)])}
    report["peak_gb"] = (max(torch.cuda.max_memory_allocated(d) for d in cards) / 1e9
                         if torch.device(args.device).type == "cuda" else None)
    if sanitize.enabled():
        report["sanitize"] = sanitize.snapshot()
    print(f"[worker {args.shard}] pass {args.pass_idx}: published {n} partial(s)", flush=True)
    print(REPORT + json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
