"""Pass orchestration: drive the CCA data passes from an on-disk store.

Port of ``repro/store/passes.py``.  ``PassRunner`` joins three layers:

- the store (:mod:`repro_torch.store.format`), streamed pass by pass
  through a prefetcher (:mod:`repro_torch.store.prefetch`): disk reads
  into page-locked host buffers and host-to-device copies on a copy
  stream overlap the fold of the chunk before;
- the pass engine (:class:`repro_torch.exec.PassEngine`), which owns the
  canonical chunk → merge group → pairwise tree fold;
- a PASS CURSOR (:mod:`repro_torch.ckpt`), saved every ``ckpt_every``
  chunks: the accumulator state (the open merge group and the closed
  groups' stack), the Qa/Qb the pass runs on (the seeds on a seeded
  pass 0), and where to go on.  ``fit(..., resume=True)`` continues a
  killed fit from the latest cursor, seeking the store past the folded
  prefix, and gives the uninterrupted result bit for bit (the same
  updates of the same f32 accumulators).  The cursor embeds the store's
  fingerprint, the engine, the hyper-parameters, the merge group size
  and Ω's provenance; a resume against any other fails loudly.

On a card, how far ahead chunks go is a residency rule computed up front
(:func:`residency`): two chunk pairs on the device only where both fit
beside the pass state, and ``prefetch`` page-locked host pairs within
half the host's free memory.

:class:`SlotSet` is the same pipeline for the device slots of a mesh
fold (the Sharded topology, a Hybrid worker): each slot's device and
stream, its page-locked host slots and device ring, and the residency
rule of each card with the slots (and the processes) that share it.

``prefetch="auto"`` / ``sync_chunks="auto"`` choose the pipeline from a
calibration window (:func:`choose_pipeline`).  Per-pass read, stall and
rate numbers land in ``RCCAResult.diagnostics["io"]``.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
from typing import List, Optional, Union

import torch

from .. import obs
from ..ckpt import CheckpointManager
from ..ckpt.checkpoint import flatten
from ..core.rcca import (DEFAULT_ENGINE, RCCAConfig, RCCAResult, algo_meta, resolve_engine,
                         resolve_omega, stats_init_fn, stats_like)
from ..device import DEFAULT_DEVICE, resolve_device
from ..exec import MERGE_GROUP_CHUNKS, PassEngine, SegmentedAccumulator
from .format import ViewStoreReader
from .prefetch import DeviceStaging, HostSlots, HostStaging, SlotStaging, prefetched

#: Cursor layout version: a cursor of another layout fails loudly.
CURSOR_FMT = 2


def choose_pipeline(read_chunk_s: float, compute_chunk_s: float):
    """Map a measured per-chunk (read, compute) pair to ``(prefetch
    depth, sync_chunks)``: no prefetch thread when reads are noise
    (ratio < 0.05); else depth ≈ read/compute + 1, from 2 to 8, and a
    strict per-chunk bound once IO is at least half the compute."""
    ratio = read_chunk_s / max(compute_chunk_s, 1e-9)
    if ratio < 0.05:
        return 0, 4
    depth = min(8, max(2, math.ceil(ratio) + 1))
    sync = 1 if ratio >= 0.5 else 4
    return depth, sync


def _host_free_bytes() -> int:
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def residency(reader: ViewStoreReader, cfg: RCCAConfig, device: torch.device,
              depth: int, share: int = 1) -> dict:
    """The prefetch residency rule of a fit on a card, computed up front.

    Device look-ahead (a second chunk pair on the card, copied during the
    fold of the first) only where two pairs plus the pass state fit in
    this process's part of the card: what the card has free when the
    rule is computed, plus what this process's allocator already holds,
    divided by ``share``, the processes that fold on the card side by
    side (a cluster's workers).  The pass state is Q, the open group's
    f32 stats and one (d, k̃) workspace per view (the torch engine's ΔY).
    At Europarl width and 8192-row chunks a pair is 34.4 GB and the state
    25.9 GB, so the copy waits for the fold's release; the disk reads
    still overlap it.  Host slots: ``depth`` page-locked pairs, as many as
    fit in half the host's free memory (at least one)."""
    item = torch.empty((), dtype=reader.torch_dtype).element_size()
    q_item = torch.empty((), dtype=cfg.dtype).element_size()
    pair = reader.chunk * (reader.da + reader.db) * item
    state = (reader.da + reader.db) * cfg.sketch * (q_item + 4 + 4)
    free, total = torch.cuda.mem_get_info(device)
    card = (free + torch.cuda.memory_reserved(device)) / max(1, share)
    host = _host_free_bytes()
    want = max(1, depth)
    slots = max(1, min(want, host // 2 // pair))
    return {"pair_gb": pair / 1e9, "state_gb": state / 1e9, "card_gb": card / 1e9,
            "card_total_gb": total / 1e9, "share": max(1, share),
            "lookahead": 2 * pair + state <= card, "host_free_gb": host / 1e9,
            "host_slots": slots, "host_slots_wanted": want}


def residency_line(rule: dict) -> str:
    need = 2 * rule["pair_gb"] + rule["state_gb"]
    ahead = ("device look-ahead of one chunk pair" if rule["lookahead"] else
             "no device look-ahead (a chunk's copy waits for the fold before it)")
    part = "" if rule["share"] == 1 else f" (1/{rule['share']} of the free memory)"
    return (f"[store] residency: chunk pair {rule['pair_gb']:.2f} GB, pass state "
            f"{rule['state_gb']:.2f} GB; 2 pairs + state = {need:.2f} GB "
            f"{'<=' if rule['lookahead'] else '>'} card {rule['card_gb']:.2f} GB{part} of "
            f"{rule['card_total_gb']:.2f}: {ahead}; "
            f"host slots {rule['host_slots']} of {rule['host_slots_wanted']} wanted "
            f"({rule['host_free_gb']:.2f} GB host memory free)")


class SlotSet:
    """The device slots of a mesh fold over one chunk source.

    access:   a ``ViewStoreReader`` (or ``exec.StackedChunks``): the chunk
              geometry and storage dtype of the host slots;
    cfg:      the :class:`RCCAConfig` (the residency rule's pass state);
    devices:  the slots (``exec.topology.resolve_slots``), a card possibly
              more than once;
    prefetch: read-ahead chunk pairs per slot (0: synchronous reads);
    share:    processes that fold on the same cards side by side (a Hybrid
              fit's workers).

    On a card each slot has its own CUDA stream, made here.  The rule of
    :func:`residency` is computed (and printed) once per card, its share
    the card's slots × ``share``; the host's half of free memory is split
    between the slots.  Page-locked host slots are made at the first fold
    and kept until :meth:`close`.  ``io`` collects each fold's read-ahead
    numbers.
    """

    def __init__(self, access, cfg: RCCAConfig, devices, *, prefetch: int = 2, share: int = 1):
        self.access = access
        self.devices = [torch.device(d) for d in devices]
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]
        self.prefetch = int(prefetch)
        self.rules: dict = {}
        self.depth = self.prefetch
        cards = [d for d in dict.fromkeys(self.devices) if d.type == "cuda"]
        for card in cards:
            here = sum(d == card for d in self.devices)
            rule = residency(access, cfg, card, self.prefetch * len(self.devices),
                             share=here * max(1, int(share)))
            print(residency_line(rule) + f" [{card}: {here} slot(s)]", flush=True)
            self.rules[card] = rule
        if cards and self.prefetch:
            host = self.rules[cards[0]]["host_slots"]
            self.depth = max(1, min(self.prefetch, host // len(self.devices)))
        self._host: List[Optional[HostSlots]] = [None] * len(self.devices)
        self.io: List[dict] = []

    def __len__(self) -> int:
        return len(self.devices)

    def context(self, i: int):
        """Slot ``i``'s device and stream current (nothing on the host)."""
        stack = contextlib.ExitStack()
        if self.streams[i] is not None:
            stack.enter_context(torch.cuda.device(self.devices[i]))
            stack.enter_context(torch.cuda.stream(self.streams[i]))
        return stack

    def _staging(self, i: int):
        dev = self.devices[i]
        if dev.type != "cuda":
            return HostStaging(getattr(self.access, "dtype", None))
        if self._host[i] is None:
            a = self.access
            self._host[i] = HostSlots(a.chunk, a.da, a.db, a.torch_dtype)
        self._host[i].ensure(max(1, self.depth))
        with self.context(i):  # the consumer's stream is the slot's
            return DeviceStaging(dev, self._host[i], lookahead=self.rules[dev]["lookahead"])

    def prefetcher(self, chunks, slot_ids):
        """One read-ahead over ``chunks`` (raw chunks in pull order), the
        k-th delivered on slot ``slot_ids[k]``."""
        staging = SlotStaging([self._staging(i) for i in range(len(self))], slot_ids)
        return prefetched(chunks, depth=self.depth * len(self) if self.prefetch else 0,
                          staging=staging, site="mesh_gather")

    def place(self, Qa, Qb) -> list:
        """Each slot's Qa/Qb: seeds as they are, tensors on the slot's
        device (one copy per other card)."""
        if isinstance(Qa, tuple):
            return [(Qa, Qb)] * len(self)
        copies: dict = {}
        for d in self.devices:
            if d not in copies:
                copies[d] = (Qa, Qb) if Qa.device == d else (Qa.to(d), Qb.to(d))
        return [copies[d] for d in self.devices]

    def follow_current(self) -> None:
        """Each slot's stream waits for what its card's current stream has
        queued (Q, the accumulator's state)."""
        for d, s in zip(self.devices, self.streams):
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(d))

    def on_slot(self, i: int, pair, dtype: torch.dtype):
        """A delivered chunk as row-major tensors in ``dtype`` on slot
        ``i`` (no copy when it is already so)."""
        with self.context(i):
            return tuple(torch.as_tensor(x, device=self.devices[i], dtype=dtype).contiguous()
                         for x in pair)

    def mark(self, n: int) -> dict:
        """Timing events at the start of a batch on the first ``n`` slots."""
        events = None
        if any(s is not None for s in self.streams[:n]):
            events = []
            for s in self.streams[:n]:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(s)
                events.append(ev)
        return {"n": n, "events": events}

    def wait(self, marks: dict) -> Optional[list]:
        """The batch's host wait: every stream of its slots done → each
        slot stream's seconds since :meth:`mark` (None on the host)."""
        n, starts = marks["n"], marks["events"]
        if starts is None:
            return None
        ends = []
        for s in self.streams[:n]:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(s)
            ends.append(ev)
        for ev in ends:
            ev.synchronize()
        return [a.elapsed_time(b) / 1e3 for a, b in zip(starts, ends)]

    def close(self) -> None:
        """Unlock the host slots and release the streams' work."""
        for s in self.streams:
            if s is not None:
                s.synchronize()
        for h in self._host:
            if h is not None:
                h.close()
        self._host = [None] * len(self.devices)


class _CalibratingSource:
    """Chunk source that reads its first ``runner.calib_chunks`` chunks
    inline (timing each), then swaps in the pipeline the calibration
    chose, on the same staging."""

    def __init__(self, runner: "PassRunner", start: int, staging):
        self._r = runner
        self._start = start
        self._staging = staging
        self._consumed = 0
        self._inner = None
        self.read_s = 0.0
        self.chunks = 0
        self.rows = 0
        self.bytes = 0

    def __iter__(self) -> "_CalibratingSource":
        return self

    def __next__(self):
        if self._inner is not None:
            return next(self._inner)
        r = self._r
        if r._auto_done or self._consumed >= r.calib_chunks:
            r._finish_calibration()
            self._inner = prefetched(r.reader.iter_raw(self._start + self._consumed),
                                     depth=r._depth(), staging=self._staging)
            return next(self._inner)
        idx = self._start + self._consumed
        if idx >= r.reader.n_chunks:
            raise StopIteration
        self._staging.release()
        a, b = r.reader.read_chunk(idx)
        staged, dt = self._staging.stage((a, b), threading.Event())
        r._calib_reads.append(dt)
        self.read_s += dt
        self._consumed += 1
        self.chunks += 1
        self.rows += int(a.shape[0])
        self.bytes += int(a.nbytes) + int(b.nbytes)
        return self._staging.deliver(staged)

    def stats(self) -> dict:
        own = {"chunks": self.chunks, "rows": self.rows, "bytes": self.bytes,
               "read_s": round(self.read_s, 4),
               "io_stall_s": round(self.read_s, 4)}  # inline reads all stall
        if self._inner is not None:
            for k, v in self._inner.stats().items():
                own[k] = own.get(k, 0) + v
        return own

    def close(self) -> None:
        if self.chunks:  # the calibration window's inline reads (the pipeline
            # swapped in after it records its own ``io`` counter)
            obs.counter("io", site="calibration", chunks=self.chunks, rows=self.rows,
                        bytes=self.bytes, read_s=round(self.read_s, 4),
                        io_stall_s=round(self.read_s, 4))
        if self._inner is not None:
            self._inner.close()


class PassRunner:
    """Run Algorithm 1's q+1 data passes over a view store.

    reader:      an open :class:`ViewStoreReader`, or a path/URI to one.
    cfg:         the :class:`RCCAConfig`.
    engine:      per-chunk update ("kernels" | "torch").
    prefetch:    pipeline depth (page-locked host chunk pairs on a card);
                 0 reads synchronously (the baseline), "auto" calibrates.
    ckpt_dir:    where pass cursors go (None: no cursors); ``keep`` of
                 them are kept.
    ckpt_every:  cursor period, in chunks.
    sync_chunks: on a card, wait for the stream every ``sync_chunks``
                 chunks, bounding the work queued ahead of the card
                 (0: no bound; "auto" calibrates).
    merge_group: chunks per canonical merge group.
    omega:       Ω's provenance (``rcca.OMEGA_MODES``); under "seeded"
                 and the kernels engine the pass-0 cursor holds the seeds.
    device:      where the fold runs (default the card).

    Page-locked host buffers are made at the first pass and kept until
    :meth:`close`.
    """

    def __init__(self, reader, cfg: RCCAConfig, *, engine: str = DEFAULT_ENGINE,
                 prefetch: Union[int, str] = 2, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 8, keep: int = 2, sync_chunks: Union[int, str] = 4,
                 merge_group: int = MERGE_GROUP_CHUNKS, omega: str = "materialized",
                 calib_chunks: int = 4, device=DEFAULT_DEVICE):
        self.reader = reader if isinstance(reader, ViewStoreReader) else ViewStoreReader(reader)
        self.cfg = cfg
        self.engine = resolve_engine(engine)
        self.omega = resolve_omega(omega)
        self.device = resolve_device(device)
        self._auto_prefetch = prefetch == "auto"
        self._auto_sync = sync_chunks == "auto"
        self.auto_tune = self._auto_prefetch or self._auto_sync
        self.prefetch = 2 if self._auto_prefetch else int(prefetch)
        self.sync_chunks = 4 if self._auto_sync else int(sync_chunks)
        self.merge_group = int(merge_group)
        self.ckpt_every = int(ckpt_every)
        self.calib_chunks = int(calib_chunks)
        self.mgr = CheckpointManager(ckpt_dir, keep=keep) if ckpt_dir else None
        self._engine = PassEngine(cfg, engine=self.engine, merge_group=self.merge_group,
                                  device=self.device, omega=self.omega)
        self.rule: Optional[dict] = None
        self._slots: Optional[HostSlots] = None
        self._live = None
        self._live_staging = None
        self._pass_t0 = 0.0
        self._passes: list = []
        self._cursors: list = []
        self._restored: Optional[dict] = None
        self._io = self._zero_io()
        self._auto_done = not self.auto_tune
        self._auto_choice: Optional[dict] = None
        self._calib_reads: list = []
        self._calib_computes: list = []
        self._calib_last_t: Optional[float] = None

    @staticmethod
    def _zero_io() -> dict:
        return {"chunks": 0, "rows": 0, "bytes": 0, "read_s": 0.0, "io_stall_s": 0.0}

    def close(self) -> None:
        """Stop the live pipeline and unlock the host buffers."""
        self._harvest_live()
        if self._slots is not None:
            self._slots.close()
            self._slots = None

    # -- chunk source (one per pass) -----------------------------------------

    def _depth(self) -> int:
        """The prefetch depth in force: host slots bound it on a card."""
        if self.rule is None or self.prefetch == 0:
            return self.prefetch
        return min(self.prefetch, self.rule["host_slots"])

    def _staging(self):
        if self.device.type != "cuda":
            return HostStaging(self.reader.dtype)
        if self._slots is None:
            self._slots = HostSlots(self.reader.chunk, self.reader.da, self.reader.db,
                                    self.reader.torch_dtype)
        self._slots.ensure(max(1, self._depth() if self._auto_done else 1))
        return DeviceStaging(self.device, self._slots, lookahead=self.rule["lookahead"])

    def _source(self, start: int):
        """Seekable factory for ``PassEngine.run_stream``: the positional
        ``start`` makes a resume seek instead of replay."""
        self._harvest_live()
        staging = self._staging()
        if not self._auto_done:
            self._live = _CalibratingSource(self, start, staging)
        else:
            self._live = prefetched(self.reader.iter_raw(start), depth=self._depth(),
                                    staging=staging)
        self._live_staging = staging
        self._calib_last_t = None  # pass boundary: no carry-over delta
        self._pass_t0 = obs.monotonic()
        return self._live

    def _harvest_live(self) -> None:
        if self._live is None:
            return
        live, staging, self._live, self._live_staging = self._live, self._live_staging, None, None
        try:
            live.close()
        finally:
            staging.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        st = live.stats()
        for k, v in st.items():
            self._io[k] += v
        seconds = obs.monotonic() - self._pass_t0
        self._passes.append({**st, "seconds": round(seconds, 4), "prefetch_depth": self._depth(),
                             "gb_per_s": round(st["bytes"] / seconds / 1e9, 4) if seconds else 0.0})

    # -- prefetch/sync auto-tuning -------------------------------------------

    def _finish_calibration(self) -> None:
        """Fix prefetch depth and sync_chunks from the calibration window.
        The first compute sample is dropped (the first chunk's launches
        build the kernels); with too few samples the defaults stand."""
        if self._auto_done:
            return
        self._auto_done = True
        computes = self._calib_computes
        reads = self._calib_reads[1:1 + len(computes)]
        read_s = compute_s = None
        if reads and computes:
            read_s = sum(reads) / len(reads)
            compute_s = sum(computes) / len(computes)
            depth, sync = choose_pipeline(read_s, compute_s)
            if self._auto_prefetch:
                self.prefetch = depth
            if self._auto_sync:
                self.sync_chunks = sync
        self._auto_choice = {"prefetch": self.prefetch, "sync_chunks": self.sync_chunks,
                             "read_chunk_s": None if read_s is None else round(read_s, 5),
                             "compute_chunk_s": None if compute_s is None else round(compute_s, 5)}
        if self._slots is not None:
            self._slots.ensure(max(1, self._depth()))

    # -- cursor persistence ----------------------------------------------------

    def _meta(self, pass_idx: int, next_chunk: int) -> dict:
        return {"cursor_fmt": CURSOR_FMT, "pass_idx": pass_idx, "next_chunk": next_chunk,
                "engine": self.engine, "merge_group": self.merge_group, "omega": self.omega,
                "fingerprint": self.reader.fingerprint(), "algo": algo_meta(self.cfg)}

    @staticmethod
    def _payload(Q):
        """A Qa/Qb slot as a tensor: the seeds of a seeded pass 0 are two
        integers."""
        return torch.tensor(Q, dtype=torch.int64) if isinstance(Q, tuple) else Q

    def _save_cursor(self, pass_idx: int, chunk_idx: int, acc, Qa, Qb) -> None:
        t0 = obs.monotonic()
        step = pass_idx * 1_000_000 + chunk_idx
        nbytes = self.mgr.save(
            step, {"acc": acc.state(), "Qa": self._payload(Qa), "Qb": self._payload(Qb)},
            metadata=self._meta(pass_idx, chunk_idx + 1))  # acc already holds chunk_idx
        self._cursors.append({"pass_idx": pass_idx, "next_chunk": chunk_idx + 1,
                              "bytes": nbytes, "save_s": round(obs.monotonic() - t0, 4)})

    def _seeds_in_slots(self, pass_idx: int) -> bool:
        return self.omega == "seeded" and self.engine == "kernels" and pass_idx == 0

    def restore_cursor(self) -> Optional[dict]:
        """The latest pass cursor as ``PassEngine.run_stream`` resume
        state, checked against this store, engine and configuration (None
        when there is none)."""
        if self.mgr is None:
            return None
        step = self.mgr.latest_step()
        meta = self.mgr.metadata(step)
        if meta is None:
            return None
        if meta.get("cursor_fmt") != CURSOR_FMT:
            raise ValueError(
                f"pass cursor layout {meta.get('cursor_fmt')} != {CURSOR_FMT} (written by "
                "another repro_torch version) — start fresh or use the matching code")
        if meta["fingerprint"] != self.reader.fingerprint():
            raise ValueError(
                "pass cursor was written against a different store (fingerprint "
                f"{meta['fingerprint'][:12]}… != {self.reader.fingerprint()[:12]}…)")
        if meta["engine"] != self.engine:
            raise ValueError(
                f"pass cursor engine {meta['engine']!r} != runner engine {self.engine!r} — "
                "bit-identical resume holds per engine")
        if meta["algo"] != algo_meta(self.cfg):
            raise ValueError(
                f"pass cursor hyper-parameters {meta['algo']} != runner config "
                f"{algo_meta(self.cfg)}")
        if meta["merge_group"] != self.merge_group:
            raise ValueError(
                f"pass cursor merge_group {meta['merge_group']} != runner merge_group "
                f"{self.merge_group} — the canonical merge structure is part of the "
                "accumulator state")
        if meta.get("omega", "materialized") != self.omega:
            raise ValueError(
                f"pass cursor omega {meta.get('omega', 'materialized')!r} != runner omega "
                f"{self.omega!r} — Ω provenance is part of the pass state (pass-0 cursors "
                "may hold seeds, not bases)")
        t0 = obs.monotonic()
        pass_idx, next_chunk = int(meta["pass_idx"]), int(meta["next_chunk"])
        r, kt = self.reader, self.cfg.sketch
        kind = "final" if pass_idx == self.cfg.q else "power"
        like = SegmentedAccumulator.structure(
            stats_init_fn(kind, r.da, r.db, kt, self.device), r.n_chunks, self.merge_group,
            next_chunk, like=stats_like(kind, r.da, r.db, kt))
        if self._seeds_in_slots(pass_idx):
            q_like = [torch.empty(2, dtype=torch.int64, device="meta")] * 2
        else:
            q_like = [torch.empty((d, kt), dtype=self.cfg.dtype, device="meta")
                      for d in (r.da, r.db)]
        tree, _ = self.mgr.restore({"acc": like.state(), "Qa": q_like[0], "Qb": q_like[1]},
                                   step=step)
        acc = tree["acc"]
        if acc["current"] is not None:
            acc["current"] = type(acc["current"])(*(t.to(self.device) for t in acc["current"]))
        if self._seeds_in_slots(pass_idx):
            Qa, Qb = (tuple(int(v) for v in tree[k].tolist()) for k in ("Qa", "Qb"))
        else:
            Qa, Qb = (tree[k].to(self.device) for k in ("Qa", "Qb"))
        nbytes = sum(t.numel() * t.element_size() for t in flatten(tree).values())
        self._restored = {"pass_idx": pass_idx, "next_chunk": next_chunk, "bytes": nbytes,
                          "restore_s": round(obs.monotonic() - t0, 4)}
        return {"pass_idx": pass_idx, "chunk_idx": next_chunk, "acc": acc, "Qa": Qa, "Qb": Qb}

    # -- driving ---------------------------------------------------------------

    def pass_engine(self) -> PassEngine:
        """The pass engine of this runner's configuration, engine, merge
        group, Ω provenance and device (one per runner: its folds, its fits
        and a delta refit's boundary Ω all go through it)."""
        return self._engine

    def _start_rule(self) -> None:
        """On a card, compute and print the residency rule (once a fit)."""
        if self.device.type == "cuda":
            self.rule = residency(self.reader, self.cfg, self.device, self.prefetch)
            print(residency_line(self.rule), flush=True)

    def _chunk_callback(self, on_chunk):
        """The per-chunk callback ``cb(pass_idx, chunk_idx, acc, Qa, Qb)``:
        the calibration samples while the pipeline is being chosen, else a
        wait for the card every ``sync_chunks`` chunks (bounding the work
        queued ahead of it); then ``on_chunk``; then the periodic cursor
        save (with a ``ckpt_dir``)."""
        counters = {"chunks": 0}

        def sync():
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()

        def cb(pass_idx, chunk_idx, acc, Qa_, Qb_):
            counters["chunks"] += 1
            if not self._auto_done:
                # calibration: wait for every chunk; its compute time is the
                # gap since the previous one less its read
                sync()
                now = obs.monotonic()
                if self._calib_last_t is not None and \
                        len(self._calib_reads) > len(self._calib_computes) + 1:
                    read = self._calib_reads[len(self._calib_computes) + 1]
                    self._calib_computes.append(max(0.0, now - self._calib_last_t - read))
                self._calib_last_t = now
            elif self.sync_chunks and counters["chunks"] % self.sync_chunks == 0:
                sync()  # bound the work queued ahead of the card
            if on_chunk is not None:
                on_chunk(pass_idx, chunk_idx, acc, Qa_, Qb_)
            if self.mgr is not None and (chunk_idx + 1) % self.ckpt_every == 0:
                self._save_cursor(pass_idx, chunk_idx, acc, Qa_, Qb_)
        return cb

    def fold(self, pass_idx: int, kind: str, acc, Qa, Qb, *, start: int = 0):
        """Fold chunks [``start``, n_chunks) of pass ``pass_idx`` into
        ``acc`` (an accumulator over this store's chunk count, its state
        at ``start``) through the fit's prefetcher, update function and
        sync bound: a delta refit's range fold.  Its IO lands in
        :meth:`io_passes`."""
        if self.rule is None:
            self._start_rule()
        cb = self._chunk_callback(None)
        try:
            self.pass_engine().fold_pass(
                self._source, pass_idx, kind, acc, Qa, Qb, start_chunk=start,
                on_chunk=lambda ci, acc_: cb(pass_idx, ci, acc_, Qa, Qb))
        finally:
            self._harvest_live()
        return acc

    def io_passes(self) -> list:
        """Per-fold IO since the last :meth:`fit` (``diagnostics["io"]
        ["passes"]``'s layout): one entry per pass or :meth:`fold`."""
        return list(self._passes)

    def fit(self, Qa=None, Qb=None, *, seed: Optional[int] = None, resume: bool = False,
            on_chunk=None, on_pass_complete=None) -> RCCAResult:
        """All q+1 passes → :class:`RCCAResult`, from Ω = (Qa, Qb) or
        ``seed`` under ``omega``.

        ``resume=True`` continues from the latest cursor in ``ckpt_dir``
        (a fresh fit when there is none).  ``on_chunk(pass_idx,
        chunk_idx, acc, Qa, Qb)`` runs after each chunk's fold and BEFORE
        the periodic cursor save, so a test can kill the fit and the last
        published cursor stays consistent.  ``on_pass_complete`` is
        :meth:`PassEngine.run_stream`'s.
        """
        self._restored = None
        resume_state = self.restore_cursor() if resume else None
        r = self.reader
        self._io = self._zero_io()
        self._passes, self._cursors = [], []
        self._start_rule()
        t0 = obs.monotonic()
        cb = self._chunk_callback(on_chunk)

        def pc(pass_idx, kind, acc, Qa_, Qb_):
            self._harvest_live()
            if on_pass_complete is not None:
                on_pass_complete(pass_idx, kind, acc, Qa_, Qb_)

        try:
            res = self.pass_engine().run_stream(
                self._source, r.da, r.db, Qa, Qb, seed=seed, resume_state=resume_state,
                on_pass_end=cb, on_pass_complete=pc, n_chunks=r.n_chunks)
        finally:
            self._harvest_live()
        wall = obs.monotonic() - t0
        rows = self._io["rows"]
        res.diagnostics["io"] = {
            **{k: round(v, 4) if isinstance(v, float) else v for k, v in self._io.items()},
            "prefetch_depth": self._depth(),
            "sync_chunks": self.sync_chunks,
            "wall_s": round(wall, 4),
            "rows_per_s": round(rows / wall, 2) if wall > 0 else float("inf"),
            "resumed": resume_state is not None,
            "passes": self._passes,
            "cursors_saved": self._cursors,
            "cursor_restored": self._restored,
            "residency": self.rule,
        }
        if self._auto_choice is not None:
            res.diagnostics["io"]["auto"] = self._auto_choice
        return res
