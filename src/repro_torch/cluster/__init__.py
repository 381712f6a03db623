"""Multi-worker map/combine/reduce execution of the two-pass algorithm
(port of ``repro.cluster``).

- :mod:`~repro_torch.cluster.partials` — mergeable statistics as a
  versioned on-disk format (the map output, the combine input);
- :mod:`~repro_torch.cluster.worker` — one shard of one pass, resumable
  mid-shard, runnable under any scheduler;
- :mod:`~repro_torch.cluster.coordinator` — spawns the workers, runs each
  pass's barrier with re-dispatch of failed or stuck workers, and merges
  the partials through the canonical pairwise tree: bitwise the Local
  fit's for any worker count.
"""

from . import partials
from .coordinator import ClusterCoordinator
from .worker import WorkerKilled, run_worker

__all__ = ["ClusterCoordinator", "WorkerKilled", "partials", "run_worker"]
