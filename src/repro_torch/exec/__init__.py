"""Pass execution — the engine behind the streaming drivers, the
topologies and the incremental delta-refits (port of ``repro.exec``)."""

from .accumulate import (MERGE_GROUP_CHUNKS, PairwiseStack, SegmentedAccumulator, SpanCombiner,
                         merge_stats, reduce_group_partials)
from .delta import FitState, PassCapture, delta_chunks, delta_refit, fit_with_state
from .engine import (PassEngine, StackedChunks, fit, fold_groups_on_mesh, n_full_chunks,
                     open_source, pass_schedule, run_fold)
from .topology import Cluster, Hybrid, Local, Sharded, as_topology, resolve_slots

__all__ = [
    "Cluster",
    "FitState",
    "Hybrid",
    "Local",
    "MERGE_GROUP_CHUNKS",
    "PairwiseStack",
    "PassCapture",
    "PassEngine",
    "SegmentedAccumulator",
    "Sharded",
    "SpanCombiner",
    "StackedChunks",
    "as_topology",
    "delta_chunks",
    "delta_refit",
    "fit",
    "fit_with_state",
    "fold_groups_on_mesh",
    "merge_stats",
    "n_full_chunks",
    "open_source",
    "pass_schedule",
    "reduce_group_partials",
    "resolve_slots",
    "run_fold",
]
