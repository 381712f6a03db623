"""Pass execution — the engine behind the streaming drivers (Local
topology; port of ``repro.exec``)."""

from .accumulate import MERGE_GROUP_CHUNKS, PairwiseStack, SegmentedAccumulator, merge_stats
from .engine import PassEngine, StackedChunks, pass_schedule, run_fold

__all__ = [
    "MERGE_GROUP_CHUNKS",
    "PairwiseStack",
    "PassEngine",
    "SegmentedAccumulator",
    "StackedChunks",
    "merge_stats",
    "pass_schedule",
    "run_fold",
]
