"""Structured spans and counters: the one trace stream of the pass stack.

Port of ``repro/obs/trace.py``.  Every process of a fit (launcher,
coordinator, cluster workers) appends JSONL records to its own file
``trace-<pid>.jsonl`` under the directory named by the ``RCCA_TRACE``
environment variable (the value ``1`` selects ``rcca_trace/``).  Each
record is written with one ``os.write`` on an ``O_APPEND`` descriptor, so
threads and processes interleave whole lines and a killed worker leaves
at worst one torn last line, which the reader skips.

Record shapes (all carry ``ev``, ``t`` = epoch seconds, ``pid``, ``tid``
= the recording OS thread's id, and the process's ``ctx`` dict from
:func:`set_context`):

* ``{"ev": "span", "name": ..., "t": t0, "dur": seconds, "sid": n,
  "parent": m | None, "attrs": {...}}``: one record per completed
  ``with span(...)`` block.  ``sid`` is unique in the process; ``parent``
  is the enclosing span's sid on the same thread.
* ``{"ev": "ctr", "name": ..., "parent": m | None, "fields": {...}}``: a
  named bundle of numeric (or short string, for grouping) fields.
* ``{"ev": "proto", "op": ..., "path": ..., "meta": {...}}``: a cluster
  protocol event mirrored from :mod:`repro_torch.analysis.protocol`.

The reference's trace files and the port's are read by either package.

**Spans around work on the card.**  PyTorch returns before the card has
done what it was given, so a host clock around a fold measures its
enqueue.  :func:`device_span` on a CUDA device records a CUDA event
(``enable_timing``) on the current stream when it is entered and when it
exits; the span keeps its host ``t`` and ``dur`` and gains ``device_s``,
the stream's seconds between the two events.  Its record waits in the
thread's pending list until the host span that encloses it (the pass)
exits: then ONE ``synchronize()`` on the last pending event resolves them
all and they are written, just before the enclosing span's own record.
That is the only wait tracing adds.  A device span with no enclosing
span resolves at its own exit.  A span whose events cannot be resolved
raises: it is never written without ``device_s``.  On the CPU,
:func:`device_span` is :func:`span`.

When ``RCCA_TRACE`` is unset every entry point is a no-op: ``span`` and
``device_span`` return a shared null context manager and ``counter``
returns before building its record.  Call sites that loop per chunk
branch on :func:`enabled` and keep their loop as it was.

This module is the clock of pass-path code: :func:`monotonic` and
:func:`wall`, so that spans, counters and diagnostics share one clock.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

TRACE_ENV = "RCCA_TRACE"
DEFAULT_DIR = "rcca_trace"

monotonic = time.perf_counter
wall = time.time


def trace_dir() -> Optional[str]:
    """The trace directory, or None when tracing is off."""
    val = os.environ.get(TRACE_ENV)
    if not val:
        return None
    return DEFAULT_DIR if val == "1" else val


def enabled() -> bool:
    return bool(os.environ.get(TRACE_ENV))


_CTX: Dict[str, Any] = {}
_FDS: Dict[str, int] = {}
_FDS_LOCK = threading.Lock()
_SIDS = itertools.count(1)
_TLS = threading.local()


def set_context(**attrs: Any) -> Dict[str, Any]:
    """Stamp process-wide attributes (fit_id, role, shard) on every record
    (None removes one) → their previous values, to restore them with."""
    prev = {k: _CTX.get(k) for k in attrs}
    for k, v in attrs.items():
        if v is None:
            _CTX.pop(k, None)
        else:
            _CTX[k] = v
    return prev


def _fd(dir_: str) -> int:
    """This process's descriptor on its file in ``dir_``; a file deleted
    since it was opened is created anew (with its directory), so records
    never go to an unlinked inode."""
    path = os.path.join(dir_, f"trace-{os.getpid()}.jsonl")
    with _FDS_LOCK:
        fd = _FDS.get(path)
        if fd is not None and os.fstat(fd).st_nlink == 0:
            os.close(fd)
            fd = None
        if fd is None:
            os.makedirs(dir_, exist_ok=True)
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            _FDS[path] = fd
        return fd


def close() -> None:
    """Close this process's trace files; the next record opens its file
    again."""
    with _FDS_LOCK:
        for fd in _FDS.values():
            os.close(fd)
        _FDS.clear()


def _emit(rec: Dict[str, Any], ctx: Optional[Dict[str, Any]] = None) -> None:
    """Write ``rec`` stamped with ``ctx`` (default: the process's context
    now)."""
    dir_ = trace_dir()
    if dir_ is None:
        return
    rec["pid"] = os.getpid()
    rec["tid"] = threading.get_native_id()
    ctx = dict(_CTX) if ctx is None else ctx
    if ctx:
        rec["ctx"] = ctx
    line = json.dumps(rec, sort_keys=True, default=str) + "\n"
    os.write(_fd(dir_), line.encode())


def _stack() -> List[int]:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def _pending() -> list:
    """This thread's device spans whose events are not resolved yet:
    ``[(sid, record, start event, end event, ctx), ...]`` in exit order."""
    p = getattr(_TLS, "pending", None)
    if p is None:
        p = _TLS.pending = []
    return p


def _record_event(device) -> Any:
    """A timing CUDA event recorded on ``device``'s current stream."""
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def resolve_pending(after_sid: int) -> int:
    """Resolve and write this thread's pending device spans entered after
    span ``after_sid``: one ``synchronize()`` on
    the last one's end event, then each span's ``device_s`` from its two
    events.  Returns how many were written.  Raises when an event cannot
    be resolved; the spans are then not written."""
    pend = _pending()
    todo = [p for p in pend if p[0] > after_sid]
    if not todo:
        return 0
    pend[:] = [p for p in pend if p[0] <= after_sid]
    todo[-1][3].synchronize()
    for sid, rec, start, end, _ in todo:
        try:
            rec["device_s"] = start.elapsed_time(end) / 1e3
        except Exception as e:
            raise RuntimeError(f"trace: the device events of span {rec['name']!r} (sid {sid}) "
                               f"cannot be resolved: {e}") from e
    for _, rec, _, _, ctx in todo:
        _emit(rec, ctx)
    return len(todo)


class _Span:
    """Context manager recording one span at exit (also when unwinding)."""

    __slots__ = ("name", "attrs", "sid", "parent", "_t0", "_w0")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        st = _stack()
        self.parent = st[-1] if st else None
        self.sid = next(_SIDS)
        st.append(self.sid)
        self._w0 = wall()
        self._t0 = monotonic()
        return self

    def _record(self) -> Dict[str, Any]:
        dur = monotonic() - self._t0
        st = _stack()
        if st and st[-1] == self.sid:
            st.pop()
        rec: Dict[str, Any] = {"ev": "span", "name": self.name, "t": self._w0, "dur": dur,
                               "sid": self.sid, "parent": self.parent}
        if self.attrs:
            rec["attrs"] = self.attrs
        return rec

    def __exit__(self, *exc: Any) -> None:
        rec = self._record()
        resolve_pending(self.sid)  # the device spans inside this one go first
        _emit(rec)


class _DeviceSpan(_Span):
    """A span that also times its stretch of ``device``'s current stream."""

    __slots__ = ("device", "_start")

    def __init__(self, name: str, device, attrs: Dict[str, Any]):
        super().__init__(name, attrs)
        self.device = device

    def __enter__(self) -> "_DeviceSpan":
        super().__enter__()
        self._start = _record_event(self.device)
        return self

    def __exit__(self, *exc: Any) -> None:
        end = _record_event(self.device)
        rec = self._record()
        _pending().append((self.sid, rec, self._start, end, dict(_CTX)))
        if self.parent is None:
            resolve_pending(self.sid - 1)


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None


_NULL = _NullSpan()


def span(name: str, **attrs: Any) -> Any:
    """``with span("pass", pass_idx=0):``; a no-op when tracing is off."""
    if not os.environ.get(TRACE_ENV):
        return _NULL
    return _Span(name, attrs)


def _on_card(device) -> bool:
    return getattr(device, "type", device) == "cuda"


def device_span(name: str, device, **attrs: Any) -> Any:
    """:func:`span` around work enqueued on ``device``: on a CUDA device
    its record gains ``device_s`` (module docstring); elsewhere it is
    :func:`span`."""
    if not os.environ.get(TRACE_ENV):
        return _NULL
    if _on_card(device):
        return _DeviceSpan(name, device, attrs)
    return _Span(name, attrs)


def counter(name: str, **fields: Any) -> None:
    """Record a named bundle of numeric fields (strings allowed for
    grouping, e.g. ``kernel="proj_stage"`` or ``site="prefetch"``)."""
    if not os.environ.get(TRACE_ENV):
        return
    st = _stack()
    _emit({"ev": "ctr", "name": name, "t": wall(), "parent": st[-1] if st else None,
           "fields": fields})


def proto_event(rec: Dict[str, Any]) -> None:
    """Mirror a cluster-protocol event into the stream (``op``, ``path``
    and ``meta`` stay top-level, where ``check_trace`` reads them)."""
    if not os.environ.get(TRACE_ENV):
        return
    out = dict(rec)
    out["ev"] = "proto"
    out["t"] = wall()
    _emit(out)


def iter_events(path: str) -> Iterator[Dict[str, Any]]:
    """Records of a trace file, or of every ``*.jsonl`` file of a
    directory in name order; a line that does not parse (a killed
    writer's torn last line) is skipped."""
    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path) if f.endswith(".jsonl"))
    else:
        files = [path]
    for fp in files:
        with open(fp, "r", encoding="utf-8", errors="replace") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    yield rec


def load_events(path: str) -> List[Dict[str, Any]]:
    return list(iter_events(path))
