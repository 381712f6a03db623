"""Synthetic paired views with planted canonical correlations.

Port of ``repro/data/synthetic.py``:

- :class:`PlantedCCAData` — the port's own copy of the numpy generator,
  chunk for chunk the same numbers as the reference's (the tests feed
  both packages from it);
- :class:`DevicePlantedChunks` — the same model made on the device from a
  ``torch.Generator`` keyed on ``(seed, chunk)``, for runs at Europarl
  width where a host-made chunk pair (34 GB) would dominate.  Same
  distribution, not the same bits.

Both draw A = Z Wa + σ Ea/√da, B = Z Wb + σ Eb/√db with Z ~ N(0, I_r)
scaled by s_i = (i+1)^{-decay}, so the canonical correlations decay
like a power law (the paper's Fig-1 spectrum).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device


def _chunk_seed(seed: int, idx: int) -> int:
    return (seed + 1) * 1_000_003 + idx


def _weights_seed(seed: int) -> int:
    """Generator key of the device model's Wa, Wb: apart from every
    chunk's key and from ``draw_omega(seed)``'s (``seed`` itself), so Ω
    is not drawn from the same numbers as the data."""
    return _chunk_seed(seed, -1)


@dataclasses.dataclass
class PlantedCCAData:
    """Two views A (n×da), B (n×db) with planted correlations (numpy)."""

    n: int
    da: int
    db: int
    rank: int = 64
    decay: float = 0.7
    noise: float = 0.5
    seed: int = 0
    chunk: int = 1024

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.scales = np.arange(1, self.rank + 1, dtype=np.float32) ** (-self.decay)
        self.Wa = rng.standard_normal((self.rank, self.da), np.float32) / np.sqrt(self.da)
        self.Wb = rng.standard_normal((self.rank, self.db), np.float32) / np.sqrt(self.db)

    @property
    def n_chunks(self) -> int:
        return (self.n + self.chunk - 1) // self.chunk

    def get_chunk(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic chunk — replayable from any index."""
        lo = idx * self.chunk
        m = min(lo + self.chunk, self.n) - lo
        rng = np.random.default_rng(_chunk_seed(self.seed, idx))
        Z = rng.standard_normal((m, self.rank)).astype(np.float32) * self.scales
        Ea = rng.standard_normal((m, self.da)).astype(np.float32)
        Eb = rng.standard_normal((m, self.db)).astype(np.float32)
        A = Z @ self.Wa + self.noise * Ea / np.sqrt(self.da)
        B = Z @ self.Wb + self.noise * Eb / np.sqrt(self.db)
        return A, B

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for i in range(self.n_chunks):
            yield self.get_chunk(i)

    def materialize(self) -> Tuple[np.ndarray, np.ndarray]:
        """Small-scale only: stack all chunks."""
        As, Bs = zip(*list(self))
        return np.concatenate(As), np.concatenate(Bs)


class DevicePlantedChunks:
    """The planted model generated chunk by chunk on ``device``.

    Chunk ``i`` comes from a generator seeded with a function of
    ``(seed, i)``, so every pass replays the same rows.  Each view is
    made in place in f32 — ``normal_`` into the output, then ``mul_`` and
    ``addmm_`` — so no temporary of the chunk's size exists, and is cast
    to ``dtype`` as soon as it is made (before the next view is), so a
    bf16 chunk pair never sits beside its f32 pair: at Europarl width
    that is 16 GiB against 32.
    """

    def __init__(self, n: int, da: int, db: int, *, rank: int = 64,
                 decay: float = 0.7, noise: float = 0.5, seed: int = 0,
                 chunk: int = 1024, dtype=torch.float32, device=DEFAULT_DEVICE):
        self.n, self.da, self.db, self.chunk = n, da, db, chunk
        self.rank, self.noise, self.seed, self.dtype = rank, noise, seed, dtype
        self.device = resolve_device(device)
        g = self._generator(_weights_seed(seed))
        self.scales = torch.arange(1, rank + 1, dtype=torch.float32,
                                   device=self.device) ** (-decay)
        self.Wa = torch.randn((rank, da), generator=g, device=self.device) / math.sqrt(da)
        self.Wb = torch.randn((rank, db), generator=g, device=self.device) / math.sqrt(db)

    def _generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    @property
    def n_chunks(self) -> int:
        return (self.n + self.chunk - 1) // self.chunk

    def _view(self, g, Z, W, d: int) -> torch.Tensor:
        X = torch.empty((Z.shape[0], d), dtype=torch.float32, device=self.device)
        X.normal_(generator=g)
        X.mul_(self.noise / math.sqrt(d))
        return X.addmm_(Z, W)

    def get_chunk(self, idx: int, cols_a: slice = slice(None),
                  cols_b: slice = slice(None)) -> Tuple[torch.Tensor, torch.Tensor]:
        """Chunk ``idx`` in ``dtype``; ``cols_a`` / ``cols_b`` keep only
        those feature columns of each view (a sharded rank's block), each
        copied out and cast before the next view is made, so at most one
        whole f32 view exists."""
        lo = idx * self.chunk
        m = min(lo + self.chunk, self.n) - lo
        g = self._generator(_chunk_seed(self.seed, idx))
        Z = torch.randn((m, self.rank), generator=g, device=self.device) * self.scales
        A = self._finish(self._view(g, Z, self.Wa, self.da), cols_a)
        B = self._finish(self._view(g, Z, self.Wb, self.db), cols_b)
        return A, B

    def _finish(self, X: torch.Tensor, cols: slice) -> torch.Tensor:
        """The kept columns of a view made in f32, in ``dtype`` (``X`` is
        released by the caller's rebinding)."""
        if cols != slice(None):
            X = X[:, cols].contiguous()
        return X.to(self.dtype)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        for i in range(self.n_chunks):
            yield self.get_chunk(i)

    def materialize(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Small-scale only: stack all chunks."""
        As, Bs = zip(*list(self))
        return torch.cat(As), torch.cat(Bs)
