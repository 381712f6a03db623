"""The two-pass map/combine/reduce coordinator of the cluster.

Port of ``repro/cluster/coordinator.py``.  For each of Algorithm 1's q+1
data passes the coordinator

1. spawns one worker process per shard (``python -m
   repro_torch.cluster.worker``, on the coordinator's device; any other
   scheduler could do the same), which starts up while the coordinator
2. publishes the pass's ROUND (Qa/Qb, or pass 0's seeds, and the binding
   metadata) under the cluster directory;
3. runs the BARRIER: it polls for the partials of every merge group and
   re-dispatches the groups of dead, stale-heartbeat or straggling
   workers to a fresh repair worker, at most ``max_redispatch`` times a
   pass, after which it raises and names the missing groups;
4. STREAMS the canonical pairwise tree from the partials on disk
   (``SegmentedAccumulator.push_group_span`` in group order: only the
   stack's O(log G) entries are resident, in host memory), checks the
   merged row count, and rotates the bases (``power_update_Q``) or
   finishes (``finalize_result``) on its device.

Workers fold whole merge groups with the Local fit's per-chunk updates
and the merge is the Local fit's tree, so the result is bitwise the Local
store fit's (``exec.fit`` with the same store, Ω, engine and merge group)
for any worker count and combine span, under injected kills and hangs
and after re-dispatch.  With ``devices_per_worker > 1`` (the Hybrid
topology) each worker folds its groups one per device slot
(``--devices``, the slots placed by ``exec.topology.worker_slots``), with
the same bits.

Under ``RCCA_TRACE`` the coordinator records the ``fit`` span
(``site="coordinator"``, role ``coordinator``), a ``pass`` span each
pass and inside it the ``publish``, ``barrier`` and ``merge`` spans,
whose seconds are the pass diagnostics' ``publish_s``, ``barrier_s`` and
``merge_s`` on one clock (``obs.monotonic``); the ``heartbeat`` (about
once a second at the barrier), ``redispatch`` and ``workers`` counters;
and a ``merge`` protocol event per partial merged.  The workers inherit
the variable.

Under ``RCCA_SANITIZE=1`` (or :func:`repro_torch.analysis.sanitize.override`
in the coordinator's context) the fit opens a fresh sanitizer trace, the
streamed merge fingerprints each partial as it enters the tree
(``group:g``, or ``span:gxN`` for a combined span; site
``coordinator_merge``) and each pass's merged result (``pass_end``), and
the trace lands in ``diagnostics["sanitize"]`` and in
``$RCCA_SANITIZE_OUT``.  The workers get the variable in their
environment and report their own groups' fingerprints.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import uuid
from typing import Dict, List, Optional

import torch

from .. import obs
from ..analysis import sanitize
from ..analysis.protocol import trace_event
from ..core.rcca import (DEFAULT_ENGINE, RCCAConfig, RCCAResult, algo_meta, finalize_result,
                         init_Q, omega_seeds, power_update_Q, resolve_engine, resolve_omega,
                         stats_init_fn)
from ..device import DEFAULT_DEVICE, resolve_device
from ..exec.accumulate import MERGE_GROUP_CHUNKS, SegmentedAccumulator
from ..exec.topology import worker_slots
from ..kernels import build
from ..kernels import rand as krand
from ..store import ViewStoreReader
from . import partials as pt
from .worker import REPORT, rss_gb

#: Seconds a worker may take to exit once every group of its pass is in.
EXIT_GRACE_S = 30.0
#: Seconds a worker waits for its round (workers start while it is written).
ROUND_WAIT_S = 600.0

#: The ``src`` directory that holds ``repro_torch``: workers import the
#: package from there wherever they are started.
SRC_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _reap(procs: Dict[int, subprocess.Popen]) -> None:
    """Kill and wait for the workers that still run."""
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


class ClusterCoordinator:
    """Drive a multi-worker two-pass fit over a view store.

    store:             a view store path/URI, or an open ``ViewStoreReader``.
    cfg:               the :class:`RCCAConfig`.
    cluster_dir:       the directory for rounds, partials, cursors,
                       heartbeats and logs (on a real cluster, one that
                       every worker mounts).
    n_workers:         worker processes per pass.
    engine:            the data-pass engine, binding for every partial.
    merge_group:       chunks per merge group; the Local fit's value gives
                       its bits.
    combine_groups:    each worker pre-merges runs of this many groups
                       (a power of two) into one span partial; the result
                       does not move.
    omega:             Ω's provenance (``rcca.OMEGA_MODES``), binding; under
                       ``"seeded"`` pass 0's round carries the seeds.
    devices_per_worker: each worker's device slots (above 1: the Hybrid
                       topology's workers);
    worker_devices:    their placement, ``Hybrid.devices``'s rule (None: the
                       cards from ``w·devices_per_worker`` on, or host slots);
    prefetch:          each worker's prefetch depth.
    ckpt_every:        each worker's cursor period, in chunks.
    worker_timeout:    seconds a pass may run before its live workers are
                       killed as stragglers and their groups re-dispatched.
    heartbeat_timeout: seconds a worker's beacon may go stale before it is
                       killed and its groups re-dispatched (None: off).
    max_redispatch:    repair rounds per pass before the pass raises.
    env_overrides:     {shard: {env}} for a shard's first worker of each
                       pass (fault injection; repair workers never get it).
    device:            where the workers fold and the coordinator works
                       (the card by default).
    """

    def __init__(self, store, cfg: RCCAConfig, cluster_dir: str, *, n_workers: int = 2,
                 engine: str = DEFAULT_ENGINE, merge_group: int = MERGE_GROUP_CHUNKS,
                 combine_groups: int = 1, omega: str = "materialized",
                 devices_per_worker: int = 1, worker_devices=None, prefetch: int = 2,
                 ckpt_every: int = 4, worker_timeout: Optional[float] = 600.0,
                 heartbeat_timeout: Optional[float] = None, max_redispatch: int = 3,
                 env_overrides: Optional[Dict[int, dict]] = None, device=DEFAULT_DEVICE):
        if isinstance(store, ViewStoreReader):
            self.reader, self.store_path = store, store.path
        else:
            self.reader, self.store_path = ViewStoreReader(store), store
        self.cfg = cfg
        self.cluster_dir = cluster_dir
        self.n_workers = int(n_workers)
        self.engine = resolve_engine(engine)
        self.merge_group = int(merge_group)
        self.combine_groups = int(combine_groups)
        self.omega = resolve_omega(omega)
        self.prefetch = int(prefetch)
        self.ckpt_every = int(ckpt_every)
        self.worker_timeout = worker_timeout
        self.heartbeat_timeout = heartbeat_timeout
        self.max_redispatch = int(max_redispatch)
        self.env_overrides = env_overrides or {}
        self.device = resolve_device(device)
        if self.n_workers < 1:
            raise ValueError("need at least one worker")
        self.devices_per_worker = int(devices_per_worker)
        if self.devices_per_worker < 1:
            raise ValueError("need at least one device per worker")
        # each worker's slots, checked against the visible cards before any spawn
        self.worker_slots = (worker_slots(self.n_workers, self.devices_per_worker,
                                          worker_devices, self.device)
                             if self.devices_per_worker > 1 else None)
        if self.combine_groups < 1 or self.combine_groups & (self.combine_groups - 1):
            raise ValueError(f"combine_groups must be a power of two (a combined span must be "
                             f"one subtree of the canonical reduction), got "
                             f"{self.combine_groups}")
        os.makedirs(os.path.join(cluster_dir, "logs"), exist_ok=True)
        # (pass, group, span) → error of a stale-partial removal that failed:
        # reported in the diagnostics and retried at every pass's sweep
        self._clean_pending: Dict[tuple, str] = {}

    @property
    def n_groups(self) -> int:
        return -(-self.reader.n_chunks // self.merge_group)

    # -- processes ----------------------------------------------------------

    def _spawn(self, shard: int, pass_idx: int, *, groups=None,
               extra_env: Optional[dict] = None) -> subprocess.Popen:
        cmd = [sys.executable, "-m", "repro_torch.cluster.worker",
               "--store", self.store_path, "--cluster-dir", self.cluster_dir,
               "--shard", str(shard), "--n-shards", str(self.n_workers),
               "--pass-idx", str(pass_idx), "--prefetch", str(self.prefetch),
               "--ckpt-every", str(self.ckpt_every), "--device", self.device.type,
               "--round-wait-s", str(ROUND_WAIT_S)]
        if groups is not None:
            cmd += ["--groups", ",".join(str(g) for g in groups)]
        if self.worker_slots is not None:  # a repair worker takes a worker's slots
            cmd += ["--devices", ",".join(self.worker_slots[shard % self.n_workers])]
        env = dict(os.environ)
        env["PYTHONPATH"] = SRC_ROOT + (os.pathsep + env["PYTHONPATH"]
                                        if env.get("PYTHONPATH") else "")
        if self.device.type == "cuda":  # workers share the card: give freed pages back
            env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
        if sanitize.enabled():  # the coordinator's context may turn it on, not the environment
            env[sanitize.ENV] = "1"
        if extra_env:
            env.update(extra_env)
        with open(pt.log_path(self.cluster_dir, shard, pass_idx), "ab") as log:
            return subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT)

    def _owned(self, shard: int) -> List[int]:
        return [g for g in range(self.n_groups)
                if (g // self.combine_groups) % self.n_workers == shard]

    def _kill_stale(self, procs: Dict[int, subprocess.Popen], pass_idx: int,
                    spawned_at: Dict[int, float]) -> List[int]:
        """The heartbeat monitor: kill live workers whose beacon (or, if
        they never beat, whose spawn) is older than the threshold; the
        re-dispatch path then takes their groups.  An age is bounded by the
        time since the spawn, so an earlier fit's beacon left under the
        same key never condemns a fresh worker."""
        if self.heartbeat_timeout is None:
            return []
        stale = []
        now = obs.monotonic()
        for shard, p in procs.items():
            if p.poll() is not None:
                continue
            since_spawn = now - spawned_at.get(shard, now)
            age = pt.heartbeat_age(self.cluster_dir, shard, pass_idx)
            age = since_spawn if age is None else min(age, since_spawn)
            if age > self.heartbeat_timeout:
                p.kill()
                p.wait()
                stale.append(shard)
        return stale

    def _reports(self, shards: List[int], pass_idx: int, fit_id: str) -> List[dict]:
        """The reports this fit's workers of ``pass_idx`` printed (a killed
        worker prints none)."""
        out = []
        for shard in shards:
            try:
                with open(pt.log_path(self.cluster_dir, shard, pass_idx)) as f:
                    lines = f.read().splitlines()
            except FileNotFoundError:
                continue
            for line in lines:
                if line.startswith(REPORT):
                    rep = json.loads(line[len(REPORT):])
                    if rep.get("fit_id") == fit_id and rep.get("pass_idx") == pass_idx:
                        out.append(rep)
        return out

    # -- one pass -------------------------------------------------------------

    def _barrier(self, pass_idx: int, expect: dict, procs: Dict[int, subprocess.Popen],
                 spawned: List[int]) -> tuple:
        """Wait until every merge group is covered by a valid partial,
        re-dispatching → (plan, redispatched groups, stale shards)."""
        spawned_at = {s: obs.monotonic() for s in procs}
        redispatched: List[int] = []
        stale_shards: List[int] = []
        attempts = 0
        deadline = obs.monotonic() + self.worker_timeout if self.worker_timeout else None
        last_liveness = -1.0
        while True:
            plan, missing = pt.collect_coverage(self.cluster_dir, pass_idx, self.n_groups,
                                                expect)
            if not missing:
                return plan, redispatched, stale_shards
            now = obs.monotonic()
            if obs.enabled() and now - last_liveness >= 1.0:
                # liveness beside the compute spans: the live workers' beacon ages
                last_liveness = now
                for shard, p in procs.items():
                    if p.poll() is not None:
                        continue
                    age = pt.heartbeat_age(self.cluster_dir, shard, pass_idx)
                    since = now - spawned_at.get(shard, now)
                    obs.counter("heartbeat", shard=int(shard),
                                age_s=round(since if age is None else min(age, since), 3),
                                pass_idx=int(pass_idx), missing_groups=len(missing))
            stale_shards.extend(self._kill_stale(procs, pass_idx, spawned_at))
            timed_out = deadline is not None and obs.monotonic() > deadline
            if timed_out:  # stragglers: kill, then re-dispatch
                for p in procs.values():
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            if timed_out or all(p.poll() is not None for p in procs.values()):
                attempts += 1
                if attempts > self.max_redispatch:
                    raise RuntimeError(
                        f"pass {pass_idx}: merge groups {missing} still missing after "
                        f"{self.max_redispatch} re-dispatch round(s); see "
                        f"{self.cluster_dir}/logs")
                # a repair worker with a shard id outside the striped range,
                # so its cursors and log never meet an owner's
                redispatched.extend(missing)
                obs.counter("redispatch", pass_idx=int(pass_idx), groups=len(missing),
                            attempt=attempts)
                repair = self.n_workers + attempts - 1
                procs.clear()
                procs[repair] = self._spawn(repair, pass_idx, groups=missing)
                spawned.append(repair)
                spawned_at = {repair: obs.monotonic()}
                deadline = (obs.monotonic() + self.worker_timeout if self.worker_timeout
                            else None)
            time.sleep(0.05)

    def _merge(self, pass_idx: int, kind: str, expect: dict, plan: dict):
        """The streamed tree: each partial read from disk and pushed in
        group order, its binding checked again → merged stats (host)."""
        r = self.reader
        sanitize.set_context(pass_idx=int(pass_idx), kind=kind, site="coordinator_merge")
        acc = SegmentedAccumulator(stats_init_fn(kind, r.da, r.db, self.cfg.sketch, "cpu"),
                                   r.n_chunks, self.merge_group)
        try:
            g = 0
            while g < self.n_groups:
                span, _ = plan[g]
                loaded = pt.read_partial(self.cluster_dir, pass_idx, g, span)
                if loaded is None:
                    raise RuntimeError(f"pass {pass_idx}: the partial of group {g} vanished "
                                       "before the merge")
                stats, meta = loaded
                if not pt.binding_matches(meta, expect):  # at-most-once guard
                    raise RuntimeError(f"pass {pass_idx}: stale partial for group {g} at "
                                       "merge time")
                trace_event("merge", pt.partial_path(self.cluster_dir, pass_idx, g, span),
                            fit_id=expect["fit_id"], pass_idx=int(pass_idx), group=int(g),
                            span=int(span))
                acc.push_group_span(g, stats, span)
                del stats, loaded
                g += span
            merged = acc.result()
            sanitize.observe("pass_end", merged)
            return merged
        finally:
            acc.close()

    def _run_pass(self, pass_idx: int, kind: str, Qa, Qb, expect: dict, fit_id: str):
        """Publish → barrier → streamed merge → (merged stats on the
        coordinator's device, the pass's diagnostics)."""
        t0 = obs.monotonic()
        procs: Dict[int, subprocess.Popen] = {}
        spawned: List[int] = []
        try:  # the workers spawned so far go if publishing fails
            with obs.span("publish", pass_idx=int(pass_idx), kind=kind):
                # stale-partial hygiene before the barrier polls: retry the
                # removals that failed earlier, then sweep this pass for other
                # fits' leftovers
                for key in list(self._clean_pending):
                    if pt.clear_stale_partial(self.cluster_dir, *key) is None:
                        del self._clean_pending[key]
                for (g, span), err in pt.sweep_stale_partials(self.cluster_dir, pass_idx,
                                                              self.n_groups, expect).items():
                    self._clean_pending[(pass_idx, g, span)] = err
                # the workers start while the round is written (they wait for
                # it): an earlier fit's round of this pass goes first, or they
                # would read it
                shutil.rmtree(pt.round_dir(self.cluster_dir, pass_idx), ignore_errors=True)
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()  # the workers need the card's memory
                for s in range(self.n_workers):
                    if self._owned(s):
                        procs[s] = self._spawn(s, pass_idx,
                                               extra_env=self.env_overrides.get(s))
                        spawned.append(s)
                round_bytes = pt.write_round(self.cluster_dir, pass_idx, Qa, Qb,
                                             {**expect, "n_shards": self.n_workers,
                                              "combine": self.combine_groups})
        except BaseException:
            _reap(procs)
            raise
        t_barrier = obs.monotonic()
        with obs.span("barrier", pass_idx=int(pass_idx), kind=kind):
            try:
                plan, redispatched, stale = self._barrier(pass_idx, expect, procs, spawned)
                # every group is in: let the workers exit (a report is printed
                # last), and kill what still runs after a grace period
                for p in procs.values():
                    try:
                        p.wait(timeout=EXIT_GRACE_S)
                    except subprocess.TimeoutExpired:
                        pass
            finally:
                _reap(procs)
        t_merge = obs.monotonic()
        with obs.span("merge", pass_idx=int(pass_idx), kind=kind, groups=self.n_groups,
                      partials=len(plan)):
            merged = self._merge(pass_idx, kind, expect, plan)
            rss_merge = rss_gb()  # the merged stats still on the host
            merged = type(merged)(*(t.to(self.device) for t in merged))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        now = obs.monotonic()
        obs.counter("workers", pass_idx=int(pass_idx), spawned=len(spawned))
        reports = self._reports(spawned, pass_idx, fit_id)
        launches: Dict[str, int] = {}
        for rep in reports:
            for k, v in rep.get("launches", {}).items():
                launches[k] = launches.get(k, 0) + v
        diag = {
            "wall_s": round(now - t0, 4),
            "publish_s": round(t_barrier - t0, 4),
            "barrier_s": round(t_merge - t_barrier, 4),
            "merge_s": round(now - t_merge, 4),
            "round_bytes": round_bytes,
            "partial_bytes": sum(pt.partial_bytes(self.cluster_dir, pass_idx, g, span)
                                 for g, (span, _) in plan.items()),
            "cursor_bytes": sum(sum(rep.get("cursor_bytes", [])) for rep in reports),
            "merge_fan_in": len(plan),
            "rss_gb_after_merge": round(rss_merge, 4),
            "workers_spawned": len(spawned),
            "redispatched_groups": sorted(set(redispatched)),
            "stale_heartbeat_shards": sorted(set(stale)),
            "stale_clean_failures": {f"p{p:05d}_g{g:05d}x{s}": e
                                     for (p, g, s), e in sorted(self._clean_pending.items())},
            "launches": launches,
            "workers": reports,
        }
        return merged, diag

    # -- driving --------------------------------------------------------------

    def _materialize_omega(self, seed_a, seed_b):
        """Pass 0's seeds → the Ω bases, at a boundary where the coordinator
        needs the arrays (the centering correction, the q = 0 finalize)."""
        r, cfg = self.reader, self.cfg
        return (krand.dense_omega(seed_a, r.da, cfg.sketch, cfg.dtype, device=self.device),
                krand.dense_omega(seed_b, r.db, cfg.sketch, cfg.dtype, device=self.device))

    def fit(self, seed: Optional[int] = None, Qa=None, Qb=None) -> RCCAResult:
        """All q+1 passes across ``n_workers`` processes → :class:`RCCAResult`
        from Ω = (Qa, Qb) or ``seed`` under ``omega``; bitwise the Local
        store fit's."""
        # the fit's identity binds partials to this fit across respawns; it
        # never reaches the arithmetic or the merge order
        fit_id = uuid.uuid4().hex  # rcca: noqa[RCCA004]
        prev = obs.set_context(fit_id=fit_id, role="coordinator")
        try:
            with obs.span("fit", site="coordinator", engine=self.engine,
                          n_workers=self.n_workers, devices_per_worker=self.devices_per_worker):
                return self._fit(fit_id, seed, Qa, Qb)
        finally:
            obs.set_context(**prev)  # the process's records after the fit are not the fit's

    def _fit(self, fit_id: str, seed, Qa, Qb) -> RCCAResult:
        r, cfg = self.reader, self.cfg
        sanitize.reset()
        if self.device.type == "cuda" and self.engine == "kernels":
            build.build()  # the workers load what the coordinator built
        seeded = self.omega == "seeded"
        if Qa is not None or Qb is not None:
            if seed is not None or self.omega != "materialized":
                raise ValueError("an explicit Ω (Qa, Qb) takes omega='materialized' and no seed")
            Qa, Qb = (torch.as_tensor(q, device=self.device, dtype=cfg.dtype).contiguous()
                      for q in (Qa, Qb))
        elif seed is None:
            raise ValueError("pass Ω (Qa, Qb) or an integer seed")
        elif seeded:  # pass 0's round carries the seeds, not Ω
            Qa, Qb = omega_seeds(seed)
        else:
            Qa, Qb = init_Q(seed, r.da, r.db, cfg, omega=self.omega, device=self.device)
        passes = []
        for pass_idx in range(cfg.q + 1):
            kind = "final" if pass_idx == cfg.q else "power"
            expect = pt.binding_meta(fit_id=fit_id, pass_idx=pass_idx, kind=kind,
                                     engine=self.engine, fingerprint=r.fingerprint(),
                                     merge_group=self.merge_group, algo=algo_meta(cfg),
                                     omega=self.omega)
            with obs.span("pass", pass_idx=pass_idx, kind=kind, site="coordinator"):
                stats, diag = self._run_pass(pass_idx, kind, Qa, Qb, expect, fit_id)
                # n is an f32 accumulator: allow its rounding at huge row
                # counts, still catching a whole wrong or duplicated chunk
                if abs(float(stats.n) - r.n) > max(1.0, 1e-6 * r.n):
                    raise RuntimeError(f"pass {pass_idx} merged {float(stats.n):.0f} rows, the "
                                       f"store has {r.n}: a merge group folded the wrong "
                                       "chunks")
                t0 = obs.monotonic()
                if kind == "power":
                    if seeded and pass_idx == 0 and cfg.center:
                        Qa, Qb = self._materialize_omega(Qa, Qb)
                    Qa, Qb = power_update_Q(stats, Qa, Qb, cfg)
                    del stats
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                diag["boundary_s"] = round(obs.monotonic() - t0, 4)
            passes.append(diag)
        if seeded and cfg.q == 0:  # the finalize needs Ω itself
            Qa, Qb = self._materialize_omega(Qa, Qb)
        res = finalize_result(stats, Qa, Qb, cfg, r.da, r.db)
        res.diagnostics["cluster"] = {
            "n_workers": self.n_workers, "devices_per_worker": self.devices_per_worker,
            "topology": "hybrid" if self.devices_per_worker > 1 else "cluster",
            "worker_slots": self.worker_slots,
            "n_groups": self.n_groups, "merge_group": self.merge_group,
            "combine_groups": self.combine_groups, "omega": self.omega, "fit_id": fit_id,
            "device": str(self.device), "passes": passes,
        }
        if sanitize.enabled():
            res.diagnostics["sanitize"] = sanitize.snapshot()
            sanitize.dump()
        return res
