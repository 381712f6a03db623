"""Pass execution — the engine behind the streaming drivers, and the
topologies (port of ``repro.exec``)."""

from .accumulate import (MERGE_GROUP_CHUNKS, PairwiseStack, SegmentedAccumulator, SpanCombiner,
                         merge_stats, reduce_group_partials)
from .engine import (PassEngine, StackedChunks, fit, n_full_chunks, open_source, pass_schedule,
                     run_fold)
from .topology import Cluster, Local, Sharded, as_topology

__all__ = [
    "Cluster",
    "Local",
    "MERGE_GROUP_CHUNKS",
    "PairwiseStack",
    "PassEngine",
    "SegmentedAccumulator",
    "Sharded",
    "SpanCombiner",
    "StackedChunks",
    "as_topology",
    "fit",
    "merge_stats",
    "n_full_chunks",
    "open_source",
    "pass_schedule",
    "reduce_group_partials",
    "run_fold",
]
