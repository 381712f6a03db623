"""A mesh of ranks in the role of ``jax.sharding.Mesh``.

Port of ``repro/launch/mesh.py`` for the sharded fit.  Where the
reference's mesh holds devices and ``shard_map`` names its axes inside a
traced program, the port's :class:`Mesh` holds the ranks of a
``torch.distributed`` job laid out row-major over named axes (rank r sits
at ``numpy.unravel_index(r, shape)``, as ``jax.make_mesh`` lays out its
devices), this rank's coordinates, and one process group for each set of
axes a collective may run over.  A set of axes whose ranks are only this
one has no group (:meth:`Mesh.group` returns None) and its collectives
are skipped, so a 1 × 1 × 1 mesh needs no process group at all.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

AXES = ("pod", "data", "model")

Axes = Union[str, Sequence[str], None]


def _as_axes(axes: Axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """This rank's place in a mesh of ``torch.distributed`` ranks.

    ``shape`` maps axis name → size, as ``jax.sharding.Mesh.shape`` does.
    The job's world size must equal the mesh's size; without an
    initialized process group the mesh must be of size 1.  Constructing a
    mesh is itself collective: every rank creates every group in the
    same order.

    ``collective_seconds`` and ``collective_calls`` count the host time
    and number of the all-reduces issued through :meth:`timed` (each
    timed between two device synchronizations on CUDA).
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str] = AXES):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
        if min(shape) < 1:
            raise ValueError(f"mesh shape {shape} has an empty axis")
        initialized = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if initialized else 1
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs {math.prod(shape)} "
                             f"ranks, the job has {world}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.rank = dist.get_rank() if initialized else 0
        self.coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(self.rank, shape))))
        self.collective_seconds = 0.0
        self.collective_calls = 0
        self._groups: dict[tuple, object] = {}
        ranks = np.arange(world).reshape(shape)
        # every subset of axes that spans more than one rank, in one fixed
        # order, so that every rank calls new_group identically
        for k in range(1, len(axis_names) + 1):
            for sub in itertools.combinations(range(len(axis_names)), k):
                if math.prod(shape[i] for i in sub) == 1:
                    continue
                rest = [i for i in range(len(axis_names)) if i not in sub]
                moved = np.moveaxis(ranks, rest, list(range(len(rest))))
                for members in moved.reshape(-1, math.prod(shape[i] for i in sub)):
                    members = sorted(int(m) for m in members)
                    group = (dist.group.WORLD if len(members) == world
                             else dist.new_group(members))
                    if self.rank in members:
                        self._groups[tuple(axis_names[i] for i in sub)] = group

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"

    def _known(self, axes: Axes) -> tuple:
        axes = _as_axes(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not in the mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)  # the mesh's order

    def size(self, axes: Axes) -> int:
        """Ranks along ``axes`` (1 for none)."""
        return math.prod(self.shape[a] for a in self._known(axes))

    def index(self, axes: Axes) -> int:
        """This rank's row-major position along ``axes`` (0 for none)."""
        axes = self._known(axes)
        if not axes:
            return 0
        return int(np.ravel_multi_index([self.coords[a] for a in axes],
                                        [self.shape[a] for a in axes]))

    def group(self, axes: Axes):
        """The process group of the ranks that share this rank's
        coordinates off ``axes``; None when that is this rank alone."""
        return self._groups.get(self._known(axes))

    @contextlib.contextmanager
    def timed(self, device: torch.device):
        """Count the enclosed collective into ``collective_seconds``."""
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize(device)
            self.collective_seconds += time.perf_counter() - t0
            self.collective_calls += 1

    def all_reduce(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``x`` summed over ``axes`` IN PLACE; returns x."""
        group = self.group(axes)
        if group is None:
            return x
        with self.timed(x.device):
            dist.all_reduce(x, group=group)
        return x


def host_mesh_shape(n: int, axes: Sequence[str] = AXES) -> tuple:
    """The reference's greedy layout of ``n`` ranks: pod = 1, the model
    axis the largest power of two whose square fits ``n``, data the rest."""
    m = 1
    while (m * 2) ** 2 <= n:
        m *= 2
    return (1, max(1, n // m), m) if len(axes) == 3 else (max(1, n // m), m)


def make_host_mesh(shape: Optional[Sequence[int]] = None, axes: Sequence[str] = AXES) -> Mesh:
    """A mesh over the job's ranks (``host_mesh_shape`` of the world size
    unless ``shape`` is given); a shape shorter than ``axes`` takes the
    trailing axis names."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if shape is None:
        shape = host_mesh_shape(world, axes)
    axes = tuple(axes)
    return Mesh(shape, axes[-len(shape):] if len(shape) < len(axes) else axes)


def data_axes(mesh: Mesh) -> tuple:
    """The row/batch axes present in this mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis(mesh: Mesh):
    return "model" if "model" in mesh.axis_names else None
