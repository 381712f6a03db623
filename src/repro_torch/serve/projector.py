"""Batched projection serving: request coalescing and zero-drop hot swap.

Port of ``repro/serve/projector.py``.  :class:`BatchedProjector` is the
traffic front end: concurrent callers submit single rows of either view;
a batch thread coalesces whatever is queued into one padded device batch
per view, projects it (x ↦ x·Xa, x ↦ x·Xb) and completes each request
with its embedding, stamped with the model version that computed it.

Hot-swap contract: ``swap(new_model)`` takes effect at the next batch
boundary.  The in-flight batch completes under the old version; every
queued and later request is served by the new one; no request is
dropped or served by a half-installed model, because the batch thread
reads the model once per batch under the queue lock.

Projection (:func:`project`).  Under ``engine="kernels"`` it is
``kernels.project_rows``: on the card the CUDA ``gemm_rows_f32``, which
cuts K into fixed segments, makes each segment's partial of an element
by one ascending-k FMA chain and combines the partials by one fixed tree
whose shape depends on K alone (not ``matmul_nn``'s one chain over K).
So a row's embedding has the same bits at every batch size and the
version stamp can be held bitwise (``x @ Xa(v)`` of the row alone).
``engine="torch"`` is ``torch.matmul``, the oracle engine (cuBLAS picks
its kernel, or a split-K, by the batch size).  On the CPU both take a
plain version.

Padding: a batch of r requests is padded to the next power of two (at
most ``max_batch``), so the projection sees a handful of shapes.

Under ``RCCA_TRACE`` each batch is a ``serve_batch`` span (occupancy,
version) with a ``serve_occupancy`` counter, each swap a ``serve_swap``
counter, and an index build an ``index_build`` span.

:class:`CorpusIndex` holds one view's projected corpus for cross-view
top-k retrieval: score(query, row) = Σ_k ρ_k·φ_k(query)·φ_k(row).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from .registry import ServedModel

ENGINES = ("kernels", "torch")


def _engine(engine: str) -> str:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    return engine


def project(X: torch.Tensor, x, engine: str = "kernels") -> torch.Tensor:
    """Rows ``x`` (numpy or a tensor, (n, d) or (d,)) times ``X`` (d, k)
    on ``X``'s device, in f32: ``project_rows`` under the kernels engine
    (each row's bits fixed by d alone), ``torch.matmul`` under the torch
    engine."""
    from ..kernels import project_rows

    x = torch.as_tensor(x, dtype=torch.float32).to(X.device, non_blocking=False)
    if _engine(engine) == "torch":
        return torch.matmul(x, X.float())
    out = project_rows(x.reshape(-1, x.shape[-1]).contiguous(), X.float().contiguous())
    return out.reshape(*x.shape[:-1], out.shape[-1])


def _bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return min(b, max(cap, n))


class _Ticket:
    """One in-flight request; completed by the batch thread."""

    __slots__ = ("view", "x", "_event", "emb", "version", "error")

    def __init__(self, view: str, x: np.ndarray):
        self.view = view
        self.x = x
        self._event = threading.Event()
        self.emb: Optional[np.ndarray] = None
        self.version: Optional[int] = None
        self.error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def fail(self, error: BaseException) -> None:
        if not self.done():
            self.error = error
            self._event.set()

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Block for the response: ``{"emb": (k,), "version": int}``."""
        if not self._event.wait(timeout):
            raise TimeoutError("projection request timed out")
        if self.error is not None:
            raise self.error
        return {"emb": self.emb, "version": self.version}


class BatchedProjector:
    """Coalesce concurrent projection requests into padded device
    batches, with hot swap between batches (module docstring).

    ``stats()`` also reports the seconds spent projecting batches (from
    the first row's copy to the device to the last embedding's return to
    the host)."""

    def __init__(self, model: ServedModel, *, max_batch: int = 64, max_wait_s: float = 0.002,
                 engine: str = "kernels"):
        if max_batch < 1:
            raise ValueError("max_batch must be positive")
        self._model = model
        self._pending_model: Optional[ServedModel] = None
        self.engine = _engine(engine)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self._cond = threading.Condition()
        self._queue: deque[_Ticket] = deque()
        self._stop = False
        self.batches = 0
        self.requests = 0
        self.swaps = 0
        self._occupancy_sum = 0
        self._batch_s = 0.0
        self._thread = threading.Thread(target=self._loop, name="rcca-serve-batch", daemon=True)
        self._thread.start()

    # -- client side ------------------------------------------------------

    def submit(self, view: str, x) -> _Ticket:
        """Queue one row of ``view`` ("a" or "b") for projection; returns a
        ticket whose ``result()`` blocks for the response."""
        if view not in ("a", "b"):
            raise ValueError(f"view must be 'a' or 'b', got {view!r}")
        x = np.asarray(x, dtype=np.float32).reshape(-1)
        with self._cond:
            model = self._pending_model or self._model
        want = model.Xa.shape[0] if view == "a" else model.Xb.shape[0]
        if x.shape[0] != want:
            raise ValueError(f"view {view} rows have {want} features, got {x.shape[0]}")
        t = _Ticket(view, x)
        with self._cond:
            if self._stop:
                raise RuntimeError("projector is shut down")
            self._queue.append(t)
            self._cond.notify_all()
        return t

    def project_a(self, x, timeout: Optional[float] = 30.0) -> Dict[str, Any]:
        return self.submit("a", x).result(timeout)

    def project_b(self, x, timeout: Optional[float] = 30.0) -> Dict[str, Any]:
        return self.submit("b", x).result(timeout)

    def swap(self, model: ServedModel) -> None:
        """Install ``model`` at the next batch boundary: the in-flight
        batch finishes on the old version; nothing is dropped."""
        with self._cond:
            self._pending_model = model
            self._cond.notify_all()

    @property
    def model(self) -> ServedModel:
        with self._cond:
            return self._pending_model or self._model

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "batches": self.batches, "requests": self.requests, "swaps": self.swaps,
                "mean_occupancy": self._occupancy_sum / self.batches if self.batches else 0.0,
                "batch_s": self._batch_s,
            }

    def close(self, timeout: float = 30.0) -> None:
        """Drain the queue, then stop the batch thread."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout)

    def __enter__(self) -> "BatchedProjector":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- batch thread -----------------------------------------------------

    def _next_batch(self) -> Optional[Tuple[ServedModel, List[_Ticket]]]:
        """Wait for requests and take a batch under the queue lock (the
        swap point); None once stopped with the queue drained."""
        with self._cond:
            while not self._queue and not self._stop:
                self._cond.wait(0.05)
            if not self._queue:
                return None
            if not self._stop and len(self._queue) < self.max_batch and self.max_wait_s > 0:
                # a brief coalescing window once traffic has started
                deadline = time.monotonic() + self.max_wait_s
                while len(self._queue) < self.max_batch:
                    left = deadline - time.monotonic()
                    if left <= 0 or self._stop:
                        break
                    self._cond.wait(left)
            if self._pending_model is not None:  # batch boundary
                self._model, self._pending_model = self._pending_model, None
                self.swaps += 1
                obs.counter("serve_swap", version=self._model.version)
            batch = [self._queue.popleft() for _ in range(min(len(self._queue), self.max_batch))]
            self.batches += 1
            self.requests += len(batch)
            self._occupancy_sum += len(batch)
            return self._model, batch

    def _loop(self) -> None:
        batch: List[_Ticket] = []
        try:
            while (taken := self._next_batch()) is not None:
                model, batch = taken
                self._run_batch(model, batch)
                batch = []
        except BaseException as e:  # the thread dies: complete, never strand
            for t in batch:
                t.fail(e)
            with self._cond:
                self._stop = True
                left = list(self._queue)
                self._queue.clear()
            for t in left:
                t.fail(RuntimeError(f"projector batch thread failed: {e!r}"))

    def _run_batch(self, model: ServedModel, batch: List[_Ticket]) -> None:
        dev = model.device
        t0 = time.perf_counter()
        with obs.span("serve_batch", occupancy=len(batch), version=model.version), \
                torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            for view in ("a", "b"):
                group = [t for t in batch if t.view == view]
                if not group:
                    continue
                X = model.Xa if view == "a" else model.Xb
                try:
                    rows = np.stack([t.x for t in group])
                    b = _bucket(len(group), self.max_batch)
                    if b > len(group):  # pad to the shape bucket
                        rows = np.concatenate(
                            [rows, np.zeros((b - len(group), rows.shape[1]), rows.dtype)])
                    # the embeddings reach the host before any ticket completes
                    emb = project(X, rows, self.engine).cpu().numpy()
                    for i, t in enumerate(group):
                        t.emb = emb[i]
                        t.version = model.version
                        t._event.set()
                except BaseException as e:  # complete, never strand
                    for t in group:
                        t.fail(e)
            obs.counter("serve_occupancy", occupancy=len(batch), max_batch=self.max_batch,
                        version=model.version)
        with self._cond:
            self._batch_s += time.perf_counter() - t0


class CorpusIndex:
    """One view's projected corpus, indexed for cross-view top-k.

    Rows are projected once at build time (streamed chunk by chunk from a
    view store: the corpus never exists beyond its embeddings) by
    :func:`project`, as the projector projects a request: under the
    kernels engine an index row is bitwise the projector's response for
    that row, whatever the chunk around it.  ``topk``
    scores a query embedding from the other view with the
    correlation-weighted inner product and returns the best rows.
    """

    def __init__(self, model: ServedModel, view: str, emb: np.ndarray):
        if view not in ("a", "b"):
            raise ValueError(f"view must be 'a' or 'b', got {view!r}")
        self.model = model
        self.view = view
        self.emb = np.asarray(emb, dtype=np.float32)  # (n, k)
        if self.emb.ndim != 2 or self.emb.shape[1] != model.k:
            raise ValueError(f"embeddings must be (n, k={model.k}), got {self.emb.shape}")

    @classmethod
    def from_store(cls, model: ServedModel, store, view: str = "b", *,
                   max_rows: Optional[int] = None, engine: str = "kernels") -> "CorpusIndex":
        """Project one view of a store chunk by chunk into an index."""
        from ..dtypes import as_tensor
        from ..store import ViewStoreReader

        reader = store if isinstance(store, ViewStoreReader) else ViewStoreReader(store)
        X = model.Xa if view == "a" else model.Xb
        parts, rows = [], 0
        with obs.span("index_build", view=view, n=reader.n):
            for i in range(reader.n_chunks):
                a, b = reader.read_chunk(i)  # views of the shard maps
                block = as_tensor(a if view == "a" else b, reader.dtype)
                parts.append(project(X, block, engine).cpu().numpy())
                rows += block.shape[0]
                del a, b, block
                if max_rows is not None and rows >= max_rows:
                    break
        emb = np.concatenate(parts)
        return cls(model, view, emb if max_rows is None else emb[:max_rows])

    def topk(self, query_emb, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k corpus rows for a query embedding from the other view:
        returns ``(indices, scores)``, scores descending."""
        q = np.asarray(query_emb, dtype=np.float32).reshape(-1)
        weighted = q * self.model.rho.detach().cpu().numpy().astype(np.float32)
        scores = self.emb @ weighted
        k = min(k, scores.shape[0])
        idx = np.argpartition(-scores, k - 1)[:k]
        order = np.argsort(-scores[idx], kind="stable")
        idx = idx[order]
        return idx, scores[idx]
