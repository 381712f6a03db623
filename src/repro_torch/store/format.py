"""Out-of-core paired-view storage: sharded .npy row files + manifest.

Port of ``repro/store/format.py``, on-disk format byte for byte::

    store/
      manifest.json           # version, n, da, db, dtype, chunk, shards
      shard_00000.a.npy       # rows [0, rows_0) of view A
      shard_00000.b.npy       # rows [0, rows_0) of view B
      ...

A store written by either package opens in the other with the same
chunks, bytes and :meth:`ViewStoreReader.fingerprint`.  Shards are plain
``.npy`` files as ``np.save`` writes them; bf16 rows are stored as their
``uint16`` bit patterns with ``"bfloat16"`` in the manifest, and read back
as ``torch.bfloat16`` through a view of those bits, so no numpy bf16 type
is needed on either side.

- The writer takes numpy arrays or tensors (a card tensor is copied to
  the host once); each shard file is written from the buffered row
  blocks as they are and hashed as it is written, which gives the sha256
  of its bytes without reading them back; the two views of a shard are
  written by two threads.
- The manifest is published atomically (tmp directory + rename): a killed
  ingest never leaves a readable store.
- The reader memory-maps shards; :meth:`ViewStoreReader.read_chunk`
  returns a chunk's rows as numpy views of the maps in the storage dtype
  (what the prefetcher copies into its page-locked buffers), and
  :meth:`~ViewStoreReader.get_chunk` as CPU tensors in the logical dtype.
- Reads route through :mod:`repro_torch.store.uri` (bare paths,
  ``file://`` and any registered scheme).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..dtypes import EXOTIC, as_tensor, bits_view, logical_name, storage_dtype, torch_dtype

STORE_VERSION = 1
MANIFEST = "manifest.json"


def _to_storage(block, logical: str) -> np.ndarray:
    """A row block (numpy array or tensor, any device) as a C-contiguous
    numpy array in the storage dtype; values are rounded to the logical
    dtype as ``astype`` would (round to nearest even)."""
    if isinstance(block, torch.Tensor):
        t = block.detach()
        if t.device.type != "cpu":
            t = t.to("cpu", dtype=torch_dtype(logical))  # the one copy off the card
        return np.ascontiguousarray(bits_view(t.to(torch_dtype(logical)).contiguous()))
    block = np.asarray(block)
    if logical in EXOTIC:
        if block.dtype == storage_dtype(logical):
            return np.ascontiguousarray(block)  # already the bits
        return _to_storage(torch.from_numpy(np.ascontiguousarray(block)), logical)
    return np.ascontiguousarray(block.astype(storage_dtype(logical), copy=False))


class _HashingFile:
    """A write-only file object that hashes what passes through it."""

    def __init__(self, f):
        self._f = f
        self.sha = hashlib.sha256()

    def write(self, data) -> int:
        self.sha.update(data)
        return self._f.write(data)


def _save_hashed(path: str, parts: list) -> str:
    """``np.save(path, np.concatenate(parts))``, byte for byte (the
    version 1.0 header ``np.save`` writes, then the rows), without
    joining the row blocks; returns the sha256 of the file's bytes as
    they are written."""
    head = np.lib.format.header_data_from_array_1_0(parts[0])
    head["shape"] = (sum(p.shape[0] for p in parts),) + parts[0].shape[1:]
    # ``path`` lies in the writer's staging directory, which one rename
    # publishes with its manifest (ViewStoreWriter.close)
    with open(path, "wb") as f:  # rcca: noqa[RCCA005]
        h = _HashingFile(f)
        np.lib.format.write_array_header_1_0(h, head)
        for p in parts:
            if p.size:
                h.write(memoryview(np.ascontiguousarray(p)).cast("B"))
    return h.sha.hexdigest()


def _split_rows(blocks: list, rows: int) -> tuple[list, list]:
    """Row blocks → (the first ``rows`` rows, the rest), as views."""
    head, tail = [], []
    for blk in blocks:
        take = min(rows, blk.shape[0])
        if take:
            head.append(blk[:take])
        if take < blk.shape[0]:
            tail.append(blk[take:])
        rows -= take
    return head, tail


def _sha256_fileobj(f, bufsize: int = 1 << 20) -> str:
    h = hashlib.sha256()
    while True:
        buf = f.read(bufsize)
        if not buf:
            break
        h.update(buf)
    return h.hexdigest()


def store_exists(path: str) -> bool:
    """True if ``path`` (bare, ``file://`` or any registered scheme)
    holds a published view store (its manifest exists)."""
    from .uri import resolve_store_path

    fs, base = resolve_store_path(path)
    return fs.exists(fs.join(base, MANIFEST))


def shard_chunks(shard: int, n_shards: int, n_chunks: int, *,
                 start: int = 0, group: int = 1):
    """Chunk assignment of worker ``shard`` of ``n_shards``: chunks are
    striped in ``group``-sized runs (merge groups), so chunk ``c`` belongs
    to worker ``(c // group) % n_shards``; the union over workers is an
    exact partition.  ``start`` seeks (chunks below it are skipped)."""
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} out of range [0, {n_shards})")
    if group <= 0:
        raise ValueError("group must be positive")
    for g in range(shard, -(-n_chunks // group), n_shards):
        for c in range(g * group, min(n_chunks, (g + 1) * group)):
            if c >= start:
                yield c


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """One physical shard: a paired (A, B) row range on disk."""

    index: int
    rows: int
    file_a: str
    file_b: str
    sha256_a: str
    sha256_b: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "ShardInfo":
        return ShardInfo(**d)


class ViewStoreWriter:
    """Ingest paired row blocks into a store directory.

    ``append(a, b)`` takes row blocks of any size (numpy arrays or
    tensors, on any device); rows are buffered and flushed as
    ``rows_per_shard``-row shard files.  ``close()`` flushes the tail and
    atomically publishes the manifest — until then the directory is not a
    readable store.  Usable as a context manager.
    """

    def __init__(self, path: str, da: int, db: int, *, dtype="float32",
                 chunk: int = 1024, rows_per_shard: Optional[int] = None):
        self.path = path
        self.da = int(da)
        self.db = int(db)
        self.dtype = logical_name(dtype)
        self.chunk = int(chunk)
        # 8 chunks per shard, as the reference
        self.rows_per_shard = int(rows_per_shard or 8 * self.chunk)
        if self.rows_per_shard <= 0 or self.chunk <= 0:
            raise ValueError("chunk and rows_per_shard must be positive")
        self._tmp = path.rstrip("/") + ".tmp"
        if os.path.exists(self._tmp):
            shutil.rmtree(self._tmp)
        os.makedirs(self._tmp, exist_ok=True)
        self._base_shards: list[ShardInfo] = []
        self._base_n = 0
        self._shards: list[ShardInfo] = []
        self._buf_a: list[np.ndarray] = []
        self._buf_b: list[np.ndarray] = []
        self._buffered = 0
        self._n = 0
        self._closed = False

    @classmethod
    def append_to(cls, path: str,
                  rows_per_shard: Optional[int] = None) -> "ViewStoreWriter":
        """Open a *published* store for shard append: geometry comes from
        its manifest, new rows land in new shard files, and ``close()``
        moves them in and then replaces the manifest atomically (readers
        opened before keep their snapshot)."""
        if not os.path.exists(os.path.join(path, MANIFEST)):
            raise FileNotFoundError(
                f"{path!r} is not a published view store; use "
                "ViewStoreWriter(...) for initial ingest")
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        if manifest.get("version") != STORE_VERSION:
            raise ValueError(f"unsupported store version {manifest.get('version')}")
        w = cls(path, manifest["da"], manifest["db"], dtype=manifest["dtype"],
                chunk=manifest["chunk"], rows_per_shard=rows_per_shard)
        w._base_shards = [ShardInfo.from_json(s) for s in manifest["shards"]]
        w._base_n = int(manifest["n"])
        w._n = w._base_n
        return w

    @property
    def _appending(self) -> bool:
        return bool(self._base_shards) or self._base_n > 0

    def append(self, a, b) -> None:
        if a.ndim != 2 or b.ndim != 2 or a.shape[0] != b.shape[0]:
            raise ValueError(f"paired row blocks required, got {tuple(a.shape)} / "
                             f"{tuple(b.shape)}")
        if a.shape[1] != self.da or b.shape[1] != self.db:
            raise ValueError(
                f"feature mismatch: got ({a.shape[1]}, {b.shape[1]}), "
                f"store is (da={self.da}, db={self.db})")
        self._buf_a.append(_to_storage(a, self.dtype))
        self._buf_b.append(_to_storage(b, self.dtype))
        self._buffered += int(a.shape[0])
        self._n += int(a.shape[0])
        while self._buffered >= self.rows_per_shard:
            self._flush(self.rows_per_shard)

    def _flush(self, rows: int) -> None:
        if rows == 0:
            return
        head_a, self._buf_a = _split_rows(self._buf_a, rows)
        head_b, self._buf_b = _split_rows(self._buf_b, rows)
        self._buffered -= rows
        idx = len(self._base_shards) + len(self._shards)
        fa = f"shard_{idx:05d}.a.npy"
        fb = f"shard_{idx:05d}.b.npy"
        # the two views in two threads: writing and hashing release the GIL
        with ThreadPoolExecutor(max_workers=2) as pool:
            ha, hb = (pool.submit(_save_hashed, os.path.join(self._tmp, fname), parts)
                      for fname, parts in ((fa, head_a), (fb, head_b)))
            ha, hb = ha.result(), hb.result()
        self._shards.append(ShardInfo(index=idx, rows=rows, file_a=fa, file_b=fb,
                                      sha256_a=ha, sha256_b=hb))

    def close(self) -> dict:
        if self._closed:
            raise RuntimeError("writer already closed")
        self._flush(self._buffered)
        manifest = {
            "version": STORE_VERSION,
            "n": self._n,
            "da": self.da,
            "db": self.db,
            "dtype": self.dtype,
            "chunk": self.chunk,
            "shards": [s.to_json() for s in (*self._base_shards, *self._shards)],
        }
        # the staging directory's manifest: published below by the rename
        # of the whole directory, or by one atomic manifest replace
        with open(os.path.join(self._tmp, MANIFEST), "w") as f:  # rcca: noqa[RCCA005]
            json.dump(manifest, f, indent=1)
        if self._appending:
            # new shard files move in under fresh names, then one atomic
            # manifest replace publishes the extended store
            for s in self._shards:
                for fname in (s.file_a, s.file_b):
                    os.replace(os.path.join(self._tmp, fname), os.path.join(self.path, fname))
            os.replace(os.path.join(self._tmp, MANIFEST), os.path.join(self.path, MANIFEST))
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._closed = True
            return manifest
        # move an old store aside BEFORE the rename, so a kill never leaves
        # a manifest whose shards are half deleted
        old = self.path.rstrip("/") + ".old"
        if os.path.exists(self.path):
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(self.path, old)
        os.rename(self._tmp, self.path)
        shutil.rmtree(old, ignore_errors=True)
        self._closed = True
        return manifest

    def __enter__(self) -> "ViewStoreWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        elif os.path.exists(self._tmp):  # a failed ingest leaves no debris
            shutil.rmtree(self._tmp, ignore_errors=True)


def ingest_chunks(path: str, chunks: Iterable[Tuple], *, chunk: int, dtype="float32",
                  rows_per_shard: Optional[int] = None) -> "ViewStoreReader":
    """Write any (a, b) row-block iterator to ``path`` and return a reader
    over it.  Feature widths are taken from the first block."""
    it = iter(chunks)
    try:
        a0, b0 = next(it)
    except StopIteration:
        raise ValueError("cannot ingest an empty chunk stream") from None
    with ViewStoreWriter(path, a0.shape[1], b0.shape[1], dtype=dtype, chunk=chunk,
                         rows_per_shard=rows_per_shard) as w:
        w.append(a0, b0)
        del a0, b0
        for a, b in it:
            w.append(a, b)
    return ViewStoreReader(path)


def extend_chunks(path: str, chunks: Iterable[Tuple], *,
                  rows_per_shard: Optional[int] = None) -> "ViewStoreReader":
    """Append an (a, b) row-block iterator to a *published* store and
    re-publish atomically (:meth:`ViewStoreWriter.append_to`)."""
    with ViewStoreWriter.append_to(path, rows_per_shard=rows_per_shard) as w:
        for a, b in chunks:
            w.append(a, b)
    return ViewStoreReader(path)


def ingest_planted(path: str, data, *, rows_per_shard: Optional[int] = None,
                   dtype="float32") -> "ViewStoreReader":
    """Ingest a planted corpus (:class:`~repro_torch.data.PlantedCCAData`,
    or :class:`~repro_torch.data.DevicePlantedChunks` on the card) chunk
    by chunk — n × d is never materialized."""
    return ingest_chunks(path, iter(data), chunk=data.chunk, rows_per_shard=rows_per_shard,
                         dtype=dtype)


class ViewStoreReader:
    """Random- and sequential-access reader over a published store.

    Shard files are memory-mapped once and sliced per chunk.  Chunk ``i``
    covers rows ``[i·chunk, min(n, (i+1)·chunk))`` and may span shards.
    """

    def __init__(self, path: str, *, mmap: bool = True):
        from .uri import resolve_store_path

        self._fs, self.path = resolve_store_path(path)
        mpath = self._fs.join(self.path, MANIFEST)
        if not self._fs.exists(mpath):
            raise FileNotFoundError(
                f"{path!r} is not a view store (no {MANIFEST}); was the writer closed?")
        with self._fs.open(mpath, "rb") as f:
            self.manifest = json.load(f)
        if self.manifest.get("version") != STORE_VERSION:
            raise ValueError(f"unsupported store version {self.manifest.get('version')}")
        self.n = int(self.manifest["n"])
        self.da = int(self.manifest["da"])
        self.db = int(self.manifest["db"])
        self.dtype = self.manifest["dtype"]
        self.chunk = int(self.manifest["chunk"])
        self.shards = [ShardInfo.from_json(s) for s in self.manifest["shards"]]
        self._mmap_mode = "r" if mmap else None
        self._starts = np.concatenate(
            [[0], np.cumsum([s.rows for s in self.shards])]).astype(np.int64)
        if self.n != int(self._starts[-1]):
            raise ValueError(
                f"manifest row count {self.n} != shard total {int(self._starts[-1])}")
        self._maps: dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    @property
    def n_chunks(self) -> int:
        return (self.n + self.chunk - 1) // self.chunk

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def nbytes(self) -> int:
        """Logical size of both views — what materializing would cost."""
        return self.n * (self.da + self.db) * storage_dtype(self.dtype).itemsize

    def fingerprint(self) -> str:
        """Content identity of the store (a hash over the shard hashes and
        the geometry); pass cursors embed it."""
        h = hashlib.sha256()
        h.update(f"{self.n}:{self.da}:{self.db}:{self.dtype}:{self.chunk}".encode())
        for s in self.shards:
            h.update(s.sha256_a.encode())
            h.update(s.sha256_b.encode())
        return h.hexdigest()

    def _shard_arrays(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if idx not in self._maps:
            s = self.shards[idx]
            a = self._fs.load_array(self._fs.join(self.path, s.file_a),
                                    mmap_mode=self._mmap_mode)
            b = self._fs.load_array(self._fs.join(self.path, s.file_b),
                                    mmap_mode=self._mmap_mode)
            if self._mmap_mode is None or not self._fs.supports_mmap:
                # eager reads keep only the shard being streamed
                self._maps.clear()
            self._maps[idx] = (a, b)
        return self._maps[idx]

    def _read_rows(self, lo: int, hi: int) -> Tuple[np.ndarray, np.ndarray]:
        """Rows [lo, hi) of both views in the storage dtype: views of the
        shard maps when they lie in one shard, else joined copies."""
        i = int(np.searchsorted(self._starts, lo, side="right") - 1)
        parts_a, parts_b = [], []
        while lo < hi:
            a, b = self._shard_arrays(i)
            base = int(self._starts[i])
            take = min(hi, int(self._starts[i + 1])) - lo
            parts_a.append(a[lo - base: lo - base + take])
            parts_b.append(b[lo - base: lo - base + take])
            lo += take
            i += 1
        if len(parts_a) == 1:
            return parts_a[0], parts_b[0]
        return np.concatenate(parts_a), np.concatenate(parts_b)

    def read_chunk(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Chunk ``idx`` as numpy arrays in the storage dtype, without a
        copy where the chunk lies in one shard (read-only views of the
        memory maps; the pages are read when the rows are)."""
        if not 0 <= idx < self.n_chunks:
            raise IndexError(f"chunk {idx} out of range [0, {self.n_chunks})")
        lo = idx * self.chunk
        return self._read_rows(lo, min(lo + self.chunk, self.n))

    def iter_raw(self, start: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """:meth:`read_chunk` from ``start`` on: the prefetcher's source."""
        for i in range(start, self.n_chunks):
            yield self.read_chunk(i)

    def get_chunk(self, idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Random access by chunk index: CPU tensors in the logical dtype."""
        a, b = self.read_chunk(idx)
        return as_tensor(a, self.dtype), as_tensor(b, self.dtype)

    def iter_chunks(self, start: int = 0) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Sequential chunk stream; ``start`` seeks without touching the
        skipped chunks' pages."""
        for i in range(start, self.n_chunks):
            yield self.get_chunk(i)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        return self.iter_chunks()

    def row_shard(self, shard: int, n_shards: int, *, start: int = 0,
                  group: int = 1) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Worker ``shard``'s chunks (:func:`shard_chunks`): strided, or
        striped in ``group``-chunk runs; ``start`` seeks."""
        for i in shard_chunks(shard, n_shards, self.n_chunks, start=start, group=group):
            yield self.get_chunk(i)

    def materialize(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """All rows in memory — only for corpora known to fit."""
        a, b = self._read_rows(0, self.n)
        return as_tensor(a, self.dtype), as_tensor(b, self.dtype)

    def verify(self) -> None:
        """Re-hash every shard file against the manifest (files in
        parallel threads: hashing releases the GIL); raises on a mismatch."""
        def rehash(fname: str) -> str:
            with self._fs.open(self._fs.join(self.path, fname), "rb") as f:
                return _sha256_fileobj(f)

        want = [(fname, sha) for s in self.shards
                for fname, sha in ((s.file_a, s.sha256_a), (s.file_b, s.sha256_b))]
        with ThreadPoolExecutor(max_workers=max(1, min(8, len(want)))) as pool:
            got = list(pool.map(rehash, [fname for fname, _ in want]))
        for (fname, sha), g in zip(want, got):
            if g != sha:
                raise ValueError(f"shard {fname} content hash mismatch: "
                                 f"manifest {sha[:12]}…, file {g[:12]}…")
