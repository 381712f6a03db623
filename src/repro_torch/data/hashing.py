"""Feature hashing (Weinberger et al., 2009) — the paper's featurizer.

Port of ``repro/data/hashing.py``, numpy only, the same slots, signs
and rows bit for bit.  Bag-of-words composed with inner-product-
preserving hashing: token t maps to slot h(t) mod d with sign
s(t) ∈ {±1}.  The paper uses 2^19 slots per language view on Europarl.
"""

from __future__ import annotations

import numpy as np


def _mix(x: np.ndarray, seed: int) -> np.ndarray:
    """Cheap splitmix64-style integer hash (vectorized, deterministic)."""
    with np.errstate(over="ignore"):
        x = x.astype(np.uint64) + np.uint64((seed * 0x9E3779B97F4A7C15) % 2**64)
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


class HashingFeaturizer:
    """Maps integer token-id bags to dense hashed feature rows (f32)."""

    def __init__(self, n_slots: int, seed: int = 0):
        self.n_slots = n_slots
        self.seed = seed

    def slots(self, token_ids: np.ndarray) -> np.ndarray:
        return (_mix(token_ids, self.seed) % np.uint64(self.n_slots)).astype(np.int64)

    def signs(self, token_ids: np.ndarray) -> np.ndarray:
        return np.where(_mix(token_ids, self.seed + 1) & np.uint64(1), 1.0, -1.0).astype(
            np.float32)

    def featurize(self, docs: list[np.ndarray]) -> np.ndarray:
        """docs: list of integer token-id arrays → (len(docs), n_slots)."""
        out = np.zeros((len(docs), self.n_slots), np.float32)
        for i, doc in enumerate(docs):
            if len(doc) == 0:
                continue
            np.add.at(out[i], self.slots(doc), self.signs(doc))
        return out

    def featurize_batch(self, token_mat: np.ndarray) -> np.ndarray:
        """token_mat: (n, L) padded token ids (0 = pad) → (n, n_slots)."""
        n, L = token_mat.shape
        out = np.zeros((n, self.n_slots), np.float32)
        valid = token_mat > 0
        rows = np.repeat(np.arange(n), L)[valid.ravel()]
        toks = token_mat.ravel()[valid.ravel()]
        np.add.at(out, (rows, self.slots(toks)), self.signs(toks))
        return out
