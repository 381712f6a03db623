"""Out-of-core paired-view store and the prefetching pass pipeline
(port of ``repro.store``).

A sharded mmap-``.npy`` on-disk format with a JSON manifest, byte for
byte the reference's (:class:`ViewStoreWriter` / :class:`ViewStoreReader`);
prefetching that overlaps shard reads and host-to-device copies with the
fold (:class:`ChunkPrefetcher`); and a pass orchestrator with a
checkpointed resume cursor (:class:`PassRunner`).
"""

from .format import (
    ShardInfo,
    ViewStoreReader,
    ViewStoreWriter,
    extend_chunks,
    ingest_chunks,
    ingest_planted,
    shard_chunks,
    store_exists,
)
from .passes import PassRunner, choose_pipeline
from .prefetch import ChunkPrefetcher, prefetched
from .uri import FsspecFS, LocalFS, StoreFS, register_scheme

__all__ = [
    "ChunkPrefetcher",
    "FsspecFS",
    "LocalFS",
    "PassRunner",
    "ShardInfo",
    "StoreFS",
    "ViewStoreReader",
    "ViewStoreWriter",
    "choose_pipeline",
    "extend_chunks",
    "ingest_chunks",
    "ingest_planted",
    "prefetched",
    "register_scheme",
    "shard_chunks",
    "store_exists",
]
