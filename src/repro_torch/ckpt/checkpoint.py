"""Checkpoints of tensor trees on a shared filesystem.

Port of ``repro/ckpt/checkpoint.py``, same layout:

- a tree (nested dicts, tuples and NamedTuples of tensors) is flattened
  to ``"/"``-joined keys (a NamedTuple's fields by name, a tuple's
  entries by index); ``None`` leaves are left out;
- each leaf is one ``.npy`` file in a step directory, beside a
  ``manifest.json`` recording every leaf's file, shape and dtype and the
  step's metadata; bf16 leaves are stored as their ``uint16`` bits;
- a step is written to a temporary directory and published by an
  atomic rename, so a killed writer never leaves a half-written
  checkpoint;
- :class:`CheckpointManager` keeps the newest ``keep`` steps.

Restoring takes a like-tree (its leaves may be ``meta`` tensors, which
hold a shape and dtype and no memory) and returns host tensors in its
structure; the caller places them.  A checkpoint's leaves are read back
exactly as written, so a resumed computation continues bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..dtypes import EXOTIC, as_tensor, bits_view, logical_name, storage_dtype

MANIFEST = "manifest.json"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree, prefix: str = "") -> dict[str, Any]:
    """``key → leaf`` of a tree of dicts, tuples and NamedTuples;
    ``None`` leaves are left out."""
    if tree is None:
        return {}
    if isinstance(tree, Mapping):
        items = tree.items()
    elif _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: dict[str, Any] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten(like, flat: Mapping[str, Any], prefix: str = ""):
    """The tree of ``like`` with every leaf replaced by ``flat``'s."""
    if like is None:
        return None
    key = (lambda k: f"{prefix}/{k}" if prefix else str(k))
    if isinstance(like, Mapping):
        return {k: unflatten(v, flat, key(k)) for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(unflatten(v, flat, key(f)) for f, v in zip(like._fields, like)))
    if isinstance(like, (tuple, list)):
        return type(like)(unflatten(v, flat, key(i)) for i, v in enumerate(like))
    return flat[prefix]


def save_pytree(tree, directory: str, *, metadata=None) -> int:
    """Write ``tree``'s tensors (any device) to ``directory`` and publish it
    atomically; returns the bytes of the leaves.  ``metadata`` is a dict,
    or a callable that returns it once the leaves are written (metadata
    computed from the leaves while they are written, e.g. a hash)."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    def write(key, leaf):
        t = torch.as_tensor(leaf).detach().to("cpu").contiguous()
        fname = key.replace("/", "__") + ".npy"
        arr = bits_view(t)
        np.save(os.path.join(tmp, fname), arr)
        return key, arr.nbytes, {"file": fname, "shape": list(arr.shape),
                                 "dtype": logical_name(t.dtype)}

    written = [write(key, leaf) for key, leaf in flatten(tree).items()]
    if callable(metadata):
        metadata = metadata()
    manifest = {"leaves": {key: info for key, _, info in written}, "metadata": metadata or {}}
    nbytes = sum(n for _, n, _ in written)
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)  # the atomic publish
    return nbytes


def _manifest(directory: str) -> dict:
    with open(os.path.join(directory, MANIFEST)) as f:
        return json.load(f)


def _load_leaf(directory: str, info: dict, mapped: bool = False) -> torch.Tensor:
    arr = np.load(os.path.join(directory, info["file"]), mmap_mode="c" if mapped else "r")
    if arr.dtype != storage_dtype(info["dtype"]):
        raise ValueError(f"checkpoint leaf {info['file']} is {arr.dtype}, manifest says "
                         f"{info['dtype']}")
    if mapped and info["dtype"] not in EXOTIC and arr.size:
        return torch.from_numpy(arr)  # a private (copy-on-write) map: no copy made here
    return as_tensor(arr, info["dtype"])


def restore_pytree(like, directory: str):
    """Host tensors in the structure of ``like``.  Every leaf of ``like``
    must be in the checkpoint with its shape and dtype, and the
    checkpoint may hold no other leaf; a mismatch raises ``ValueError``."""
    leaves = _manifest(directory)["leaves"]
    want = flatten(like)
    if set(want) != set(leaves):
        raise ValueError(f"checkpoint {directory} holds leaves {sorted(leaves)}, the "
                         f"like-tree {sorted(want)}")
    for key, t in want.items():
        info = leaves[key]
        if tuple(info["shape"]) != tuple(t.shape) or info["dtype"] != logical_name(t.dtype):
            raise ValueError(f"checkpoint leaf {key!r} is {info['dtype']}{info['shape']}, "
                             f"the like-tree's {logical_name(t.dtype)}{list(t.shape)}")
    # leaves are read side by side (file reads release the GIL); writes
    # stay one at a time: they wait on the disk's writeback either way
    with ThreadPoolExecutor(max_workers=max(1, min(8, len(want)))) as pool:
        loaded = dict(zip(want, pool.map(lambda k: _load_leaf(directory, leaves[k]), want)))
    return unflatten(like, loaded)


def load_metadata(directory: str) -> dict:
    return _manifest(directory)["metadata"]


def load_flat(directory: str, *, mapped: bool = False) -> tuple[dict, dict]:
    """A checkpoint as a flat ``key → host tensor`` dict and its metadata,
    without a like-tree.  ``mapped=True`` returns the leaves of plain
    dtypes as tensors over private memory maps of their files (read when
    used, never written back) instead of copies."""
    manifest = _manifest(directory)
    return ({k: _load_leaf(directory, info, mapped) for k, info in manifest["leaves"].items()},
            manifest["metadata"])


class CheckpointManager:
    """Step-indexed checkpoints under ``root``, the newest ``keep`` kept."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    def _steps(self) -> list[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.root)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree, *, metadata: Optional[dict] = None) -> int:
        """Write step ``step`` (then drop all but the newest ``keep``);
        returns the bytes of its leaves."""
        nbytes = save_pytree(tree, self._step_dir(step), metadata={"step": step, **(metadata or {})})
        self._gc()
        return nbytes

    def restore(self, like, *, step: Optional[int] = None):
        """(tree, metadata) of ``step`` (default: the latest), or
        (None, None) when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        d = self._step_dir(step)
        return restore_pytree(like, d), load_metadata(d)

    def metadata(self, step: Optional[int] = None) -> Optional[dict]:
        """A step's metadata without loading any tensor — for callers whose
        like-tree depends on it (the pass cursor's)."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return load_metadata(self._step_dir(step))

    def _gc(self) -> None:
        for s in self._steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
