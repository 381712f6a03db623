"""On-disk partial statistics: the cluster's merge currency.

Port of ``repro/cluster/partials.py``.  Algorithm 1's passes are sums of
per-chunk updates, so per-worker statistics merge exactly:

- a PARTIAL is the sum of one merge group's chunk updates (or, from a
  worker's combiner, the pairwise sum of an aligned dyadic span of
  groups), written atomically through :mod:`repro_torch.ckpt` as a
  checkpoint directory whose metadata binds it to everything that must
  match for the merge to be valid: the fit id, pass index, store
  fingerprint, engine, hyper-parameters, merge-group size and Ω's
  provenance, and the shard that produced it;
- a ROUND is the coordinator's broadcast of one pass: the ``Qa``/``Qb``
  bases every worker of the pass projects against, under the same
  binding metadata.  Under ``omega="seeded"`` pass 0's round carries the
  per-view seeds (two words each, as ``int64``; ``core.rcca.omega_seeds``)
  in the Qa/Qb slots instead of the (d, k̃) bases: the kernels engine
  makes Ω on the card inside the seeded stage, the torch engine makes it
  from the seed, and the broadcast is 16 bytes a view;
- the coordinator merges partials through the canonical pairwise tree
  over group indices, so the result is bitwise the Local fit's for any
  worker count and completion order, and each group enters the merge at
  most once however many workers published it (partial content is
  deterministic: duplicates are byte-identical and the last write wins).

The layout under a cluster directory (the reference's)::

    cluster/
      rounds/pass_00000/              # Qa, Qb + the round's metadata
      partials/p00000_g00003[x2]/     # one group's (or span's) stats
      workers/shard_000/pass_00000/   # per-worker resume cursors
      heartbeats/shard_000_p00000     # liveness beacons (mtime = last beat)
      logs/w000_p00000.log            # each worker's output

A worker touches its beacon at start and at every merge-group boundary
and cursor save, so a worker that hangs goes stale long before the pass
time limit.  A partial's leaves are written from host memory, one at a
time, like a pass cursor's.
"""

from __future__ import annotations

import os
import re
import shutil
import time
from typing import Dict, List, Optional, Tuple

import torch

from .. import obs
from ..analysis.protocol import trace_event
from ..ckpt import load_flat, load_metadata, save_pytree
from ..core.rcca import FinalStats, PowerStats

PARTIAL_VERSION = 1

#: Metadata keys that must agree between a round and every partial merged
#: under it: the at-most-once and staleness guard.  ``omega`` binds
#: because it changes what pass 0's Qa/Qb payload is (seeds or bases).
BINDING_KEYS = ("version", "fit_id", "pass_idx", "kind", "engine", "fingerprint",
                "merge_group", "algo", "omega")

#: partial directory names: p<pass>_g<group>[x<span>] (staging and
#: temporary suffixes do not match)
_PARTIAL_RE = re.compile(r"^p(\d{5})_g(\d{5})(?:x(\d+))?$")


def round_dir(cluster_dir: str, pass_idx: int) -> str:
    return os.path.join(cluster_dir, "rounds", f"pass_{pass_idx:05d}")


def partial_path(cluster_dir: str, pass_idx: int, group: int, span: int = 1) -> str:
    """The partial of ``span`` consecutive merge groups from ``group``; a
    span of 1 keeps the per-group name, so a combined span and a repair
    worker's per-group partial never share a directory."""
    name = f"p{pass_idx:05d}_g{group:05d}"
    if span > 1:
        name += f"x{span}"
    return os.path.join(cluster_dir, "partials", name)


def scan_partials(cluster_dir: str, pass_idx: int) -> List[Tuple[int, int]]:
    """Every ``(group, span)`` partial of a pass on disk, valid or not."""
    try:
        entries = os.listdir(os.path.join(cluster_dir, "partials"))
    except FileNotFoundError:
        return []
    out = []
    for name in entries:
        m = _PARTIAL_RE.match(name)
        if m and int(m.group(1)) == pass_idx:
            out.append((int(m.group(2)), int(m.group(3) or 1)))
    return sorted(out)


def worker_cursor_dir(cluster_dir: str, shard: int, pass_idx: int) -> str:
    return os.path.join(cluster_dir, "workers", f"shard_{shard:03d}", f"pass_{pass_idx:05d}")


def log_path(cluster_dir: str, shard: int, pass_idx: int) -> str:
    return os.path.join(cluster_dir, "logs", f"w{shard:03d}_p{pass_idx:05d}.log")


def heartbeat_path(cluster_dir: str, shard: int, pass_idx: int) -> str:
    return os.path.join(cluster_dir, "heartbeats", f"shard_{shard:03d}_p{pass_idx:05d}")


def touch_heartbeat(cluster_dir: str, shard: int, pass_idx: int) -> None:
    """Beat once: create the beacon or refresh its mtime."""
    path = heartbeat_path(cluster_dir, shard, pass_idx)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a"):
        pass
    os.utime(path, None)


def heartbeat_age(cluster_dir: str, shard: int, pass_idx: int) -> Optional[float]:
    """Seconds since the shard last beat, or None if it never has."""
    try:
        return max(0.0, obs.wall() - os.path.getmtime(heartbeat_path(cluster_dir, shard,
                                                                      pass_idx)))
    except OSError:
        return None


def binding_meta(*, fit_id: str, pass_idx: int, kind: str, engine: str, fingerprint: str,
                 merge_group: int, algo: dict, omega: str = "materialized") -> dict:
    return {"version": PARTIAL_VERSION, "fit_id": fit_id, "pass_idx": int(pass_idx),
            "kind": kind, "engine": engine, "fingerprint": fingerprint,
            "merge_group": int(merge_group), "algo": algo, "omega": omega}


def binding_matches(meta: Optional[dict], expect: dict) -> bool:
    """True when a round's or partial's metadata matches ``expect`` on
    every :data:`BINDING_KEYS` entry; anything else is stale (an earlier
    fit, another store, another engine ...) and must not merge."""
    if meta is None:
        return False
    return all(meta.get(k) == expect.get(k) for k in BINDING_KEYS)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


# -- rounds (coordinator → workers) -------------------------------------------


def _payload(Q):
    """A Qa/Qb slot as a tensor: a seeded pass 0's seed is two integers."""
    return torch.tensor(Q, dtype=torch.int64) if isinstance(Q, tuple) else Q


def write_round(cluster_dir: str, pass_idx: int, Qa, Qb, meta: dict) -> int:
    """Publish a pass's round; returns the bytes of its leaves."""
    d = round_dir(cluster_dir, pass_idx)
    nbytes = save_pytree({"Qa": _payload(Qa), "Qb": _payload(Qb)}, d, metadata=meta)
    trace_event("commit", d, pass_idx=int(pass_idx))
    return nbytes


def read_round(cluster_dir: str, pass_idx: int, *, wait_s: float = 0.0):
    """A pass's round → (Qa, Qb, metadata), host tensors over private
    memory maps of the files (a seeded pass 0: the seed tuples), waiting
    up to ``wait_s`` for the coordinator to publish it (a worker under
    another scheduler may start first)."""
    d = round_dir(cluster_dir, pass_idx)
    deadline = obs.monotonic() + wait_s
    while not os.path.exists(os.path.join(d, "manifest.json")):
        if obs.monotonic() >= deadline:
            raise FileNotFoundError(f"no round published for pass {pass_idx} under "
                                    f"{cluster_dir!r}")
        time.sleep(0.05)
    flat, meta = load_flat(d, mapped=True)
    trace_event("read", d, pass_idx=int(pass_idx))
    Qa, Qb = flat["Qa"], flat["Qb"]
    if meta.get("omega") == "seeded" and pass_idx == 0:
        Qa, Qb = (tuple(int(v) for v in q.tolist()) for q in (Qa, Qb))
    return Qa, Qb, meta


# -- partials (workers → coordinator) -----------------------------------------


def _stats_from_flat(flat: dict, kind: str):
    cls = PowerStats if kind == "power" else FinalStats
    return cls(*(flat[f] for f in cls._fields))


def write_partial(cluster_dir: str, pass_idx: int, group: int, stats, meta: dict, *,
                  shard: int, n_shards: int, span: int = 1) -> int:
    """Atomically publish the statistics of ``span`` consecutive merge
    groups from ``group`` (a power-of-two span from a worker's combiner,
    or 1); returns the bytes of the leaves.

    Two publications of one group (a re-dispatched shard racing its
    presumed-dead owner) are harmless: the content is deterministic, the
    staging rename is atomic, and the loser's copy is dropped; a stale
    leftover of an earlier fit is replaced.
    """
    final = partial_path(cluster_dir, pass_idx, group, span)
    os.makedirs(os.path.dirname(final), exist_ok=True)
    staging = f"{final}.stage{os.getpid()}"
    nbytes = save_pytree(stats._asdict(), staging,
                         metadata={**meta, "group": int(group), "span": int(span),
                                   "shard": int(shard), "n_shards": int(n_shards)})
    trace_event("stage_write", staging, group=int(group), shard=int(shard))
    try:
        os.rename(staging, final)
        trace_event("commit", final, group=int(group), shard=int(shard))
    except OSError:
        existing = partial_meta(cluster_dir, pass_idx, group, span)
        if binding_matches(existing, meta):
            shutil.rmtree(staging, ignore_errors=True)  # a twin won the race
            trace_event("twin_drop", final, group=int(group), shard=int(shard))
        else:  # a stale leftover of an earlier fit: replace it
            shutil.rmtree(final, ignore_errors=True)
            os.rename(staging, final)
            trace_event("stale_replace", final, group=int(group), shard=int(shard),
                        old_binding={k: existing.get(k) for k in BINDING_KEYS}
                        if existing else None,
                        new_binding={k: meta.get(k) for k in BINDING_KEYS})
            trace_event("commit", final, group=int(group), shard=int(shard))
    return nbytes


def read_partial(cluster_dir: str, pass_idx: int, group: int,
                 span: int = 1) -> Optional[Tuple[object, dict]]:
    """(stats as host tensors over private memory maps of the files,
    metadata), or None when not published."""
    d = partial_path(cluster_dir, pass_idx, group, span)
    if not os.path.exists(os.path.join(d, "manifest.json")):
        return None
    flat, meta = load_flat(d, mapped=True)
    trace_event("read", d, group=int(group))
    return _stats_from_flat(flat, meta["kind"]), meta


def partial_meta(cluster_dir: str, pass_idx: int, group: int,
                 span: int = 1) -> Optional[dict]:
    """Metadata only: the barrier's cheap validity poll."""
    try:
        return load_metadata(partial_path(cluster_dir, pass_idx, group, span))
    except (FileNotFoundError, KeyError, ValueError):
        return None


def partial_bytes(cluster_dir: str, pass_idx: int, group: int, span: int = 1) -> int:
    """Bytes on disk of one published partial."""
    return _dir_bytes(partial_path(cluster_dir, pass_idx, group, span))


def clear_stale_partial(cluster_dir: str, pass_idx: int, group: int,
                        span: int = 1) -> Optional[str]:
    """Remove a stale partial; returns an error string when the removal
    failed, None on success (already gone included).  A failed removal
    cannot corrupt a merge (staleness is decided by the binding), but the
    coordinator reports it and retries at its next sweep."""
    path = partial_path(cluster_dir, pass_idx, group, span)
    if not os.path.lexists(path):
        return None
    try:
        shutil.rmtree(path)
    except OSError as e:
        trace_event("clean_fail", path, group=int(group), error=str(e))
        return f"{path}: {e}"
    trace_event("clean", path, group=int(group))
    return None


def sweep_stale_partials(cluster_dir: str, pass_idx: int, n_groups: int,
                         expect: dict) -> Dict[Tuple[int, int], str]:
    """Delete every published partial of a pass whose binding does not
    match ``expect`` (leftovers of an earlier fit in a reused directory).
    Returns {(group, span): error} for removals that failed."""
    failures: Dict[Tuple[int, int], str] = {}
    for g, span in scan_partials(cluster_dir, pass_idx):
        if g >= n_groups:
            continue
        meta = partial_meta(cluster_dir, pass_idx, g, span)
        if meta is None or binding_matches(meta, expect):
            continue
        err = clear_stale_partial(cluster_dir, pass_idx, g, span)
        if err is not None:
            failures[(g, span)] = err
    return failures


def collect_partials(cluster_dir: str, pass_idx: int, n_groups: int,
                     expect: dict) -> Dict[int, dict]:
    """Group → metadata of every valid per-group (span 1) partial of a
    pass; stale ones are left out, and so re-dispatched by the barrier."""
    out = {}
    for g in range(n_groups):
        meta = partial_meta(cluster_dir, pass_idx, g)
        if binding_matches(meta, expect):
            out[g] = meta
    return out


def collect_coverage(cluster_dir: str, pass_idx: int, n_groups: int,
                     expect: dict) -> Tuple[Dict[int, Tuple[int, dict]], List[int]]:
    """Span-aware coverage of a pass's merge groups → ``(plan, missing)``:
    ``plan`` maps a start group to the ``(span, metadata)`` of the valid
    partial chosen to cover ``[start, start + span)`` (walked in ascending
    order it visits every covered group once); ``missing`` lists the
    groups no valid partial covers (the barrier's re-dispatch set).  At
    each uncovered group the widest valid aligned span wins; overlapping
    choices are byte-identical subtrees of the same reduction."""
    candidates: Dict[int, Dict[int, dict]] = {}
    for g, span in scan_partials(cluster_dir, pass_idx):
        if span & (span - 1) or g % span or g + span > n_groups:
            continue  # never written by a correct worker
        meta = partial_meta(cluster_dir, pass_idx, g, span)
        if binding_matches(meta, expect) and int(meta.get("span", 1)) == span:
            candidates.setdefault(g, {})[span] = meta
    plan: Dict[int, Tuple[int, dict]] = {}
    missing: List[int] = []
    g = 0
    while g < n_groups:
        spans = candidates.get(g)
        if not spans:
            missing.append(g)
            g += 1
            continue
        span = max(spans)
        plan[g] = (span, spans[span])
        g += span
    return plan, missing
