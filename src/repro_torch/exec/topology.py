"""Execution topologies: where the pass structure is cut.

Port of ``repro/exec/topology.py``, the three layouts the port runs:

- :class:`Local` — one process, one device: chunks fold sequentially
  (:class:`~repro_torch.exec.PassEngine`).
- :class:`Cluster` — one process per worker, each on one device, folding
  whole merge groups of a view store and publishing them as partials;
  the coordinator (:class:`~repro_torch.cluster.ClusterCoordinator`)
  merges them through the same pairwise tree from disk, so the result is
  bitwise the Local store fit's.
- :class:`Sharded` in its resident-mode role — the ranks of a
  :class:`~repro_torch.launch.mesh.Mesh` hold blocks of the rows and,
  with a ``col_axis``, of the features
  (:func:`repro_torch.core.rcca_dist.dist_randomized_cca`).  The feature
  sums reassociate the row sums, so this mode gives up the streaming
  topologies' bitwise contract for a per-rank d·k̃ / |model| footprint.

The streaming form of ``Sharded`` (merge groups folded one per device)
and ``Hybrid`` (cluster workers that each fold over a device mesh) are
not ported yet (ROADMAP Queue 1 item 3).  Topologies are frozen
declarative values: they carry the layout, not operational knobs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union


@dataclasses.dataclass(frozen=True)
class Local:
    """Single-process, single-device sequential execution."""

    name: str = dataclasses.field(default="local", init=False, repr=False)


@dataclasses.dataclass(frozen=True)
class Sharded:
    """Resident execution over a mesh of ranks.

    ``mesh``:     a :class:`~repro_torch.launch.mesh.Mesh` (the rows are
                  split over its row axes);
    ``col_axis``: the mesh axis that splits the features, or None.
    """

    mesh: Optional[object] = None
    col_axis: Optional[str] = None
    name: str = dataclasses.field(default="sharded", init=False, repr=False)


@dataclasses.dataclass(frozen=True)
class Cluster:
    """Multi-process execution: ``n_workers`` map tasks per pass, each a
    single-device process (``python -m repro_torch.cluster.worker``)."""

    n_workers: int = 2
    name: str = dataclasses.field(default="cluster", init=False, repr=False)

    def __post_init__(self) -> None:
        if self.n_workers < 1:
            raise ValueError("need at least one worker")

    @property
    def devices_per_worker(self) -> int:
        return 1


Topology = Union[Local, Sharded, Cluster]


def as_topology(spec: Union[str, Topology], **kwargs: object) -> Topology:
    """Coerce a CLI-style spec (``"local"``, ``"sharded"``, ``"cluster"``)
    or an existing topology value; ``"hybrid"`` is not ported yet."""
    if isinstance(spec, (Local, Sharded, Cluster)):
        return spec
    if spec == "hybrid":
        raise NotImplementedError(
            "the hybrid topology (cluster workers each folding over a device mesh) is not "
            "ported yet (ROADMAP Queue 1 item 3); use 'cluster' or 'local'")
    table = {"local": Local, "sharded": Sharded, "cluster": Cluster}
    if spec not in table:
        raise ValueError(f"unknown topology {spec!r}; expected one of {sorted(table)}")
    return table[spec](**kwargs)
