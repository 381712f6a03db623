"""Versioned CCA model registry: atomic publish, content hashes.

Port of ``repro/serve/registry.py``, same layout (a reader never sees a
torn artifact)::

    registry/
      <name>/
        v00001/                # one save_pytree dir per version
          manifest.json        #   Xa/Xb/rho/Qa/Qb leaves + metadata
          Xa.npy ...
        v00002/
        current.json           # atomically replaced version pointer

Each version directory is written by ``repro_torch.ckpt.save_pytree``
(staged, then renamed) and is immutable once published; ``current.json``
is the only mutable file and flips through ``os.replace``.  Version
metadata carries a content hash (sha256 over the projection leaves, with
numpy's dtype names, so a version published by either package loads in
the other with its hash verified), the store fingerprint and algo
binding inherited from the fit, and the parent version.

``prune(name, keep=N)`` removes old versions but never the current one,
its recorded parent (the rollback target) or the newest N, and deletes
by rename, then rmtree, so a concurrent reader never opens a
half-deleted artifact.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import obs
from ..ckpt import load_flat, load_metadata, save_pytree
from ..device import DEFAULT_DEVICE, resolve_device
from ..dtypes import bits_view, logical_name

_LEAVES = ("Xa", "Xb", "rho", "Qa", "Qb")
_VDIR_RE = re.compile(r"^v(\d{5})$")


def _content_hash(arrays: Dict[str, Any]) -> str:
    """sha256 over each projection leaf's name, numpy dtype name, shape
    and C-order bytes (numpy arrays or CPU tensors): the reference's."""
    h = hashlib.sha256()
    for name in _LEAVES:
        arr = arrays[name]
        if isinstance(arr, torch.Tensor):  # a bf16 leaf: its bits, its logical name
            dtype, arr = logical_name(arr.dtype), bits_view(arr.contiguous())
        else:
            dtype = str(np.asarray(arr).dtype)
        arr = np.ascontiguousarray(arr)
        h.update(name.encode())
        h.update(dtype.encode())
        h.update(str(arr.shape).encode())
        h.update(memoryview(arr).cast("B"))  # the bytes, without a copy
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class ServedModel:
    """One immutable published model version, its tensors on the
    serving device."""

    name: str
    version: int
    Xa: torch.Tensor  # (da, k) view-A projection
    Xb: torch.Tensor  # (db, k)
    rho: torch.Tensor  # (k,) canonical correlations
    Qa: torch.Tensor
    Qb: torch.Tensor
    meta: Dict[str, Any]

    @property
    def k(self) -> int:
        return int(self.Xa.shape[1])

    @property
    def device(self) -> torch.device:
        return self.Xa.device

    def project_a(self, x, engine: str = "kernels") -> torch.Tensor:
        """x ↦ x·Xa: rows of view A into the canonical space, on the
        model's device (:func:`repro_torch.serve.projector.project`)."""
        from .projector import project

        return project(self.Xa, x, engine)

    def project_b(self, x, engine: str = "kernels") -> torch.Tensor:
        from .projector import project

        return project(self.Xb, x, engine)

    def score(self, ea, eb) -> torch.Tensor:
        """Correlation score of paired embeddings: Σ_k ρ_k·φᵃ_k·φᵇ_k
        (rows of ``ea``/``eb`` are already-projected pairs)."""
        ea = torch.as_tensor(ea, device=self.device)
        eb = torch.as_tensor(eb, device=self.device)
        return torch.sum(ea * eb * self.rho, dim=-1)


class ModelRegistry:
    """Versioned model artifacts with atomic publish and flip.

    ``publish`` writes the next version directory, then flips
    ``current.json`` with ``os.replace``: readers see the old current or
    the new one, never a half-published artifact.  Versions are
    immutable; rollback is ``set_current(name, older_version)``.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # -- paths ------------------------------------------------------------

    def _model_dir(self, name: str) -> str:
        if not name or "/" in name or name.startswith("."):
            raise ValueError(f"bad model name {name!r}")
        return os.path.join(self.root, name)

    def _version_dir(self, name: str, version: int) -> str:
        return os.path.join(self._model_dir(name), f"v{version:05d}")

    # -- enumeration ------------------------------------------------------

    def models(self) -> List[str]:
        return sorted(d for d in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, d)))

    def versions(self, name: str) -> List[int]:
        d = self._model_dir(name)
        if not os.path.isdir(d):
            return []
        out = []
        for entry in os.listdir(d):
            m = _VDIR_RE.match(entry)
            if m and os.path.exists(os.path.join(d, entry, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def current_version(self, name: str) -> Optional[int]:
        path = os.path.join(self._model_dir(name), "current.json")
        try:
            with open(path) as f:
                return int(json.load(f)["version"])
        except (FileNotFoundError, KeyError, ValueError):
            return None

    # -- publish ----------------------------------------------------------

    def publish(self, name: str, result, *, fit_meta: Optional[dict] = None,
                parent: Optional[int] = None, make_current: bool = True) -> int:
        """Publish an ``RCCAResult`` (or anything with Xa/Xb/rho/Qa/Qb
        attributes) as the next version of ``name``; returns it.

        ``fit_meta`` is the binding and provenance to record (a FitState's
        ``meta``: store fingerprint, algo, engine); ``parent`` the version
        this one refitted from (default: the current one).
        """
        arrays = {leaf: torch.as_tensor(getattr(result, leaf)).detach().to("cpu").contiguous()
                  for leaf in _LEAVES}
        versions = self.versions(name)
        version = (versions[-1] + 1) if versions else 1
        if parent is None:
            parent = self.current_version(name)
        meta = {
            "name": name, "version": version, "parent": parent,
            "k": int(arrays["Xa"].shape[1]),
            "da": int(arrays["Xa"].shape[0]),
            "db": int(arrays["Xb"].shape[0]),
        }
        if fit_meta:
            meta["fit"] = {k: v for k, v in fit_meta.items()
                           if k in ("engine", "omega", "merge_group", "algo", "fingerprint", "n")}
        os.makedirs(self._model_dir(name), exist_ok=True)
        with ThreadPoolExecutor(1) as pool:  # hashed while it is written
            digest = pool.submit(_content_hash, arrays)
            save_pytree(arrays, self._version_dir(name, version),  # staged + renamed
                        metadata=lambda: {**meta, "content_sha256": digest.result()})
        obs.counter("registry_publish", model=name, version=version)
        if make_current:
            self.set_current(name, version)
        return version

    def set_current(self, name: str, version: int) -> None:
        """Atomically flip the served-version pointer."""
        if version not in self.versions(name):
            raise ValueError(f"{name!r} has no published version {version}")
        d = self._model_dir(name)
        tmp = os.path.join(d, f".current.{os.getpid()}.tmp")
        with open(tmp, "w") as f:
            json.dump({"version": version}, f)
        os.replace(tmp, os.path.join(d, "current.json"))

    # -- load -------------------------------------------------------------

    def load(self, name: str, version: Optional[int] = None, *,
             device=DEFAULT_DEVICE) -> ServedModel:
        """Load a version (default: the current one) onto ``device`` for
        serving, verifying the content hash first: a corrupted artifact
        fails here, not in traffic."""
        dev = resolve_device(device)
        if version is None:
            version = self.current_version(name)
            if version is None:
                versions = self.versions(name)
                if not versions:
                    raise FileNotFoundError(
                        f"no published versions of {name!r} under {self.root!r}")
                version = versions[-1]
        flat, meta = load_flat(self._version_dir(name, version), mapped=True)
        with ThreadPoolExecutor(1) as pool:  # hashed while it is placed
            digest = pool.submit(_content_hash, flat)
            placed = {leaf: flat[leaf].to(dev) for leaf in _LEAVES}
            got = digest.result()
        if got != meta.get("content_sha256"):
            raise ValueError(
                f"{name} v{version} content hash mismatch: artifact corrupted "
                f"({got[:12]}… != {str(meta.get('content_sha256'))[:12]}…)")
        return ServedModel(name=name, version=version, meta=meta, **placed)

    def meta(self, name: str, version: int) -> dict:
        return load_metadata(self._version_dir(name, version))

    # -- garbage collection ----------------------------------------------

    def prune(self, name: str, *, keep: int) -> List[int]:
        """Delete old versions of ``name``, keeping the newest ``keep``
        plus everything a rollback could land on; returns the versions
        removed (ascending).

        Never pruned: the current version, its recorded ``parent`` (the
        rollback target) and the newest ``keep`` versions.  A version
        directory is first renamed out of the registry's namespace
        (atomic: :meth:`versions` and :meth:`load` never see a
        half-deleted artifact; a concurrent ``load`` either opened the
        manifest before the rename and reads the moved files, or misses
        the version), and only then removed.
        """
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        versions = self.versions(name)
        protected = set(versions[-keep:])
        cur = self.current_version(name)
        if cur is not None:
            protected.add(cur)
            try:
                parent = self.meta(name, cur).get("parent")
            except (OSError, ValueError):
                parent = None
            if parent is not None:
                protected.add(int(parent))
        pruned: List[int] = []
        d = self._model_dir(name)
        for version in versions:
            if version in protected:
                continue
            trash = os.path.join(d, f".trash.v{version:05d}.{os.getpid()}")
            try:
                os.rename(self._version_dir(name, version), trash)
            except FileNotFoundError:
                continue  # a concurrent prune got it first
            shutil.rmtree(trash, ignore_errors=True)
            pruned.append(version)
        if pruned:
            obs.counter("registry_prune", model=name, n=len(pruned),
                        kept=len(versions) - len(pruned))
        return pruned
