"""Execution topologies: where the pass structure is cut.

Port of ``repro/exec/topology.py``, the two layouts the port runs so far:

- :class:`Local` — one process, one device: chunks fold sequentially
  (:class:`~repro_torch.exec.PassEngine`).
- :class:`Sharded` in its resident-mode role — the ranks of a
  :class:`~repro_torch.launch.mesh.Mesh` hold blocks of the rows and,
  with a ``col_axis``, of the features
  (:func:`repro_torch.core.rcca_dist.dist_randomized_cca`).  The feature
  sums reassociate the row sums, so this mode gives up the streaming
  topologies' bitwise contract for a per-rank d·k̃ / |model| footprint.

The reference's ``Cluster`` and ``Hybrid`` topologies and the streaming
form of ``Sharded`` (merge groups folded one per device) are not ported
yet.  Topologies are frozen declarative values: they carry the layout,
not operational knobs.
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


Topology = Union[Local, Sharded]


def as_topology(spec: Union[str, Topology], **kwargs: object) -> Topology:
    """Coerce a CLI-style spec (``"local"``, ``"sharded"``) or an existing
    topology value."""
    if isinstance(spec, (Local, Sharded)):
        return spec
    table = {"local": Local, "sharded": Sharded}
    if spec not in table:
        raise ValueError(f"unknown topology {spec!r}; expected one of {sorted(table)}")
    return table[spec](**kwargs)
