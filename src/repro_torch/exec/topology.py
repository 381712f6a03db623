"""Execution topologies: where the pass structure is cut.

Port of ``repro/exec/topology.py``.  Every topology runs the same
algorithm over the same canonical accumulation (chunk → merge group →
pairwise tree, :mod:`repro_torch.exec.accumulate`); they differ only in
which resources fold which merge groups:

- :class:`Local` — one process, one device: chunks fold sequentially
  (:class:`~repro_torch.exec.PassEngine`).
- :class:`Sharded` — one process over a list of DEVICE SLOTS
  (``devices``): whole merge groups are folded one per slot, each on its
  slot's own CUDA stream, and their sums enter the same tree in the same
  order (:func:`~repro_torch.exec.fold_groups_on_mesh`), so the result is
  bitwise the Local fit's.  A card may be named more than once: its
  slots then share it, each on its own stream (the port's counterpart of
  the reference's forced host device count).  In its resident-mode role
  (``mesh`` and ``col_axis``) the ranks of a
  :class:`~repro_torch.launch.mesh.Mesh` hold blocks of the rows and,
  with a ``col_axis``, of the features
  (:func:`repro_torch.core.rcca_dist.dist_randomized_cca`); the feature
  sums reassociate the row sums, so that mode gives up the bitwise
  contract for a per-rank d·k̃ / |model| footprint.
- :class:`Cluster` — one process per worker, each on one device, folding
  whole merge groups of a view store and publishing them as partials;
  the coordinator (:class:`~repro_torch.cluster.ClusterCoordinator`)
  merges them through the same pairwise tree from disk.
- :class:`Hybrid` — cluster workers that each fold their merge groups
  over their own device slots and publish them as a cluster worker does:
  bitwise the Local fit for any (workers × slots) layout.

Topologies are frozen declarative values: they carry the layout, not
operational knobs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

#: A slot specification: None (every visible card, or one host slot), a
#: slot count, or an explicit sequence of devices such as
#: ``("cuda:0", "cuda:0")``.
Devices = Union[None, int, Sequence[str]]


def _freeze(devices: Devices) -> Union[None, int, Tuple[str, ...]]:
    if isinstance(devices, str) and devices.isdigit():  # a count from a command line
        devices = int(devices)
    if devices is None or isinstance(devices, int):
        if devices is not None and devices < 1:
            raise ValueError(f"need at least one device slot, got {devices}")
        return devices
    if isinstance(devices, str):
        devices = [d for d in devices.split(",") if d]
    out = tuple(str(d) for d in devices)
    if not out:
        raise ValueError("an explicit slot list needs at least one device")
    return out


def resolve_slots(devices: Devices, device="cuda") -> List["torch.device"]:  # noqa: F821
    """The device slots of ``devices`` for a fit asked to run on
    ``device``.

    - None: every visible card, or one host slot when ``device`` is the
      CPU;
    - an int ``n``: the first ``n`` cards, or ``n`` host slots on the CPU;
      more than the visible cards raises and names the explicit form (a
      card is never repeated silently, and nothing drops to the CPU);
    - a sequence (or a comma-separated string) of devices, each a card
      that exists or ``"cpu"``, all of ``device``'s type; a card may
      repeat.  ``"cuda"`` is the current card.

    A string of digits is a count.
    """
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    devices = _freeze(devices)
    if dev.type == "cpu":
        if devices is None or isinstance(devices, int):
            return [torch.device("cpu")] * (devices or 1)
    elif devices is None or isinstance(devices, int):
        cards = torch.cuda.device_count()
        n = cards if devices is None else devices
        if n > cards:
            raise ValueError(
                f"{n} device slots asked for, but {cards} card(s) are visible; to put several "
                f"slots on one card name them explicitly, e.g. devices="
                f"{tuple(['cuda:0'] * n)!r}")
        return [torch.device("cuda", i) for i in range(n)]
    slots = []
    for name in devices:
        if torch.device(name).type != dev.type:
            raise ValueError(f"slot {name!r} is not on {dev.type!r}: a fit runs its slots on "
                             "one kind of device (no CPU fallback)")
        d = resolve_device(name)
        if d.type == "cuda":
            d = torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index)
            if d.index >= torch.cuda.device_count():
                raise ValueError(f"slot {name!r}: only {torch.cuda.device_count()} card(s) "
                                 "are visible")
        slots.append(d)
    return slots


@dataclasses.dataclass(frozen=True)
class Local:
    """Single-process, single-device sequential execution."""

    name: str = dataclasses.field(default="local", init=False, repr=False)


@dataclasses.dataclass(frozen=True)
class Sharded:
    """One process over device slots (streaming), or a mesh of ranks
    (resident).

    ``mesh``:     resident mode: a :class:`~repro_torch.launch.mesh.Mesh`
                  (the rows are split over its row axes);
    ``col_axis``: resident mode: the mesh axis that splits the features, or
                  None (streaming fits require None);
    ``devices``:  streaming mode: the device slots (:func:`resolve_slots`),
                  one merge group folded on each at a time.
    """

    mesh: Optional[object] = None
    col_axis: Optional[str] = None
    devices: Devices = None
    name: str = dataclasses.field(default="sharded", init=False, repr=False)

    def __post_init__(self) -> None:
        object.__setattr__(self, "devices", _freeze(self.devices))

    def slots(self, device="cuda") -> list:
        """The streaming fold's device slots for a fit on ``device``."""
        return resolve_slots(self.devices, device)


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


@dataclasses.dataclass(frozen=True)
class Hybrid:
    """Row parallelism across worker processes × group parallelism across
    each worker's device slots.

    ``devices`` places the slots: None gives worker ``w`` the cards
    ``w·devices_per_worker`` onwards (host slots on the CPU), raising when
    there are not that many; an explicit sequence of ``n_workers ×
    devices_per_worker`` devices gives worker ``w`` its ``w``-th run of
    ``devices_per_worker`` of them, e.g. ``("cuda:0",) * 4`` puts a 2 × 2
    layout on one card."""

    n_workers: int = 2
    devices_per_worker: int = 4
    devices: Optional[Sequence[str]] = None
    name: str = dataclasses.field(default="hybrid", init=False, repr=False)

    def __post_init__(self) -> None:
        if self.n_workers < 1:
            raise ValueError("need at least one worker")
        if self.devices_per_worker < 1:
            raise ValueError("need at least one device per worker")
        devices = self.devices
        if devices is not None:
            devices = _freeze(devices)
            if isinstance(devices, int) or len(devices) != self.n_workers * \
                    self.devices_per_worker:
                raise ValueError(f"Hybrid devices= names each worker's slots: "
                                 f"{self.n_workers} × {self.devices_per_worker} devices, "
                                 f"got {devices!r}")
        object.__setattr__(self, "devices", devices)


def worker_slots(n_workers: int, devices_per_worker: int, devices, device="cuda") -> list:
    """Each worker's slot list (device strings) under :class:`Hybrid`'s
    placement rule, checked against the visible cards."""
    n = n_workers * devices_per_worker
    flat = resolve_slots(n if devices is None else devices, device)
    names = ["cpu" if d.type == "cpu" else f"cuda:{d.index}" for d in flat]
    return [names[w * devices_per_worker:(w + 1) * devices_per_worker]
            for w in range(n_workers)]


Topology = Union[Local, Sharded, Cluster, Hybrid]


def as_topology(spec: Union[str, Topology], **kwargs: object) -> Topology:
    """Coerce a CLI-style spec (``"local"``, ``"sharded"``, ``"cluster"``,
    ``"hybrid"``) or an existing topology value."""
    if isinstance(spec, (Local, Sharded, Cluster, Hybrid)):
        return spec
    table = {"local": Local, "sharded": Sharded, "cluster": Cluster, "hybrid": Hybrid}
    if spec not in table:
        raise ValueError(f"unknown topology {spec!r}; expected one of {sorted(table)}")
    return table[spec](**kwargs)
