"""Pass execution — the engine behind the streaming drivers, and the
topologies (port of ``repro.exec``)."""

from .accumulate import MERGE_GROUP_CHUNKS, PairwiseStack, SegmentedAccumulator, merge_stats
from .engine import PassEngine, StackedChunks, pass_schedule, run_fold
from .topology import Local, Sharded, as_topology

__all__ = [
    "Local",
    "MERGE_GROUP_CHUNKS",
    "PairwiseStack",
    "PassEngine",
    "SegmentedAccumulator",
    "Sharded",
    "StackedChunks",
    "as_topology",
    "merge_stats",
    "pass_schedule",
    "run_fold",
]
