"""Determinism sanitizer (RCCA301): merge-boundary fingerprints.

Port of ``repro/analysis/sanitize.py``.  ``RCCA_SANITIZE=1`` turns on a
runtime recorder: the canonical accumulator
(:mod:`repro_torch.exec.accumulate`) fingerprints every merge-group sum
as it enters the pairwise tree, the points the bitwise contract
quantifies over, and the pass engines and the cluster coordinator mark
each pass's merged result (``pass_end``).  A fit leaves an ordered trace
of ``{context..., "label", "digest"}`` records in its diagnostics
(``diagnostics["sanitize"]``) and, when ``RCCA_SANITIZE_OUT`` names a
file, as JSON on disk.

Two runs that claim bit-identity must leave identical traces;
:func:`first_divergence` compares two and names the first merge boundary
where they part: "pass 0, merge group 2 already differs" rather than
"the correlations differ in the last bit".

A digest covers each leaf's key path (JAX's ``keystr`` spelling:
``.Ya`` for a NamedTuple field, ``['y']`` for a dict key), its shape,
its dtype under numpy's name (``float32``, ``bfloat16``) and its exact
bytes, so the same numpy state digests the same here and in the JAX
package.  A CUDA tensor is copied to the host slice by slice as it is
hashed (:data:`SLICE_BYTES`).

The recorder belongs to the fit, not the process: :func:`reset` opens a
fresh one in the current :mod:`contextvars` context, so two fits on two
threads of one process keep two clean traces.  :func:`override` turns
the sanitizer on or off in the current context whatever the environment
says (a caller that runs one fit sanitized beside another that is not).

This module is a leaf: it imports nothing of the package, and numpy and
torch load inside :func:`observe`, so the disabled path costs one
context lookup and one environment lookup, no device sync and no copy.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import json
import os
from typing import Iterator, List, Optional, Sequence

ENV = "RCCA_SANITIZE"
OUT_ENV = "RCCA_SANITIZE_OUT"


class _Recorder:
    """One fit's trace and its ambient labels."""

    def __init__(self):
        self.trace: List[dict] = []
        self.context: dict = {}


_recorder: contextvars.ContextVar[Optional[_Recorder]] = contextvars.ContextVar(
    "rcca_sanitize_recorder", default=None)
_forced: contextvars.ContextVar[Optional[bool]] = contextvars.ContextVar(
    "rcca_sanitize_forced", default=None)


def enabled() -> bool:
    forced = _forced.get()
    if forced is not None:
        return forced
    return os.environ.get(ENV) == "1"


@contextlib.contextmanager
def override(on: bool = True) -> Iterator[None]:
    """Sanitize (``on``) or not inside this block, in this context only,
    whatever ``RCCA_SANITIZE`` says.  A thread starts with a context of
    its own, so the block holds on the thread that enters it."""
    token = _forced.set(bool(on))
    try:
        yield
    finally:
        _forced.reset(token)


def _current() -> _Recorder:
    rec = _recorder.get()
    if rec is None:
        rec = _Recorder()
        _recorder.set(rec)
    return rec


def reset() -> None:
    """Start a fresh trace in the current context (a fit calls this at
    its start; an earlier fit's snapshot stays as it was)."""
    _recorder.set(_Recorder())


def set_context(**kv) -> None:
    """Attach ambient labels (pass index, kind, site) to later
    observations; ``None`` removes a key."""
    ctx = _current().context
    for k, v in kv.items():
        if v is None:
            ctx.pop(k, None)
        else:
            ctx[k] = v


def _leaves(tree, path: str = "") -> Iterator[tuple]:
    """(key path, leaf) in JAX's canonical order: dict keys sorted,
    NamedTuple fields and sequence items in order, None empty."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{name}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


#: Bytes of a device leaf copied to the host at a time while it is hashed.
SLICE_BYTES = 64 << 20


def _parts(leaf) -> tuple:
    """(shape, numpy dtype name, an iterator of C-order byte buffers) of
    one leaf.  A CUDA tensor goes to the host in slices of
    :data:`SLICE_BYTES` through two page-locked buffers, the copy of one
    slice overlapping the hashing of the other, so a leaf never has a whole
    host copy (at Europarl width one is 4.3 GB)."""
    import numpy as np

    try:
        import torch
    except ImportError:  # a numpy-only caller
        torch = None
    if torch is not None and isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        shape = tuple(t.shape)
        flat = t.reshape(-1).view(torch.uint8)
        if t.device.type == "cpu":
            return shape, name, iter((flat.numpy(),))
        return shape, name, _device_slices(flat)
    arr = np.asarray(leaf)
    return arr.shape, str(arr.dtype), iter((np.ascontiguousarray(arr).reshape(-1).view(np.uint8),))


def _device_slices(flat):
    """The bytes of a flat uint8 CUDA tensor, slice by slice, as numpy
    views of two page-locked host buffers used in turn."""
    import torch

    n = flat.numel()
    if n == 0:
        return
    step = min(SLICE_BYTES, n)
    bufs = [torch.empty(step, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
    done = [torch.cuda.Event(), torch.cuda.Event()]
    stream = torch.cuda.current_stream(flat.device)

    def start(i: int, lo: int) -> None:
        hi = min(lo + step, n)
        bufs[i][:hi - lo].copy_(flat[lo:hi], non_blocking=True)
        done[i].record(stream)

    start(0, 0)
    for k, lo in enumerate(range(0, n, step)):
        i = k % 2
        if lo + step < n:
            start(1 - i, lo + step)  # the next slice copies while this one is hashed
        done[i].synchronize()
        yield bufs[i][:min(step, n - lo)].numpy()


def digest(tree) -> str:
    """sha256 over every leaf's key path, shape, dtype and bytes."""
    h = hashlib.sha256()
    for path, leaf in _leaves(tree):
        shape, dtype, buffers = _parts(leaf)
        h.update(path.encode())
        h.update(str(tuple(shape)).encode())
        h.update(dtype.encode())
        for buf in buffers:
            h.update(buf)
    return h.hexdigest()


def observe(label: str, tree) -> None:
    """Fingerprint one accumulator state at a merge boundary; two
    observations agree iff the states are bit-identical."""
    if not enabled():
        return
    rec = _current()
    full = dict(rec.context)
    full["label"] = label
    full["digest"] = digest(tree)
    rec.trace.append(full)


def snapshot() -> List[dict]:
    """The current context's trace so far (a copy)."""
    return [dict(r) for r in _current().trace]


def dump(path: Optional[str] = None) -> Optional[str]:
    """Write the trace as JSON to ``path`` (default ``$RCCA_SANITIZE_OUT``)
    by a staged write and a rename; returns the path written, or None."""
    path = path or os.environ.get(OUT_ENV)
    trace = _current().trace
    if not path or not trace:
        return None
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(trace, f, indent=1)
    os.replace(tmp, path)
    return path


def load(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)


def _key(rec: dict, ignore: Sequence[str]) -> tuple:
    return tuple(sorted((k, v) for k, v in rec.items() if k != "digest" and k not in ignore))


def first_divergence(a: List[dict], b: List[dict], *,
                     ignore: Sequence[str] = ()) -> Optional[dict]:
    """The first record where two traces disagree, or None when they are
    identical: a dict naming the index, the reason (``label``, ``digest``
    or ``length``) and both records.  ``ignore`` names context keys left
    out of the comparison (``("site",)`` holds a Sharded or a cluster
    fit's trace against the Local fit's)."""
    for i, (ra, rb) in enumerate(zip(a, b)):
        if _key(ra, ignore) != _key(rb, ignore):
            return {"code": "RCCA301", "index": i, "reason": "label", "a": ra, "b": rb}
        if ra.get("digest") != rb.get("digest"):
            return {"code": "RCCA301", "index": i, "reason": "digest", "a": ra, "b": rb}
    if len(a) != len(b):
        i = min(len(a), len(b))
        return {"code": "RCCA301", "index": i, "reason": "length",
                "a": a[i] if i < len(a) else None, "b": b[i] if i < len(b) else None}
    return None
