"""URI-scheme dispatch for view-store IO.

Port of ``repro/store/uri.py`` (no change but the package names).

The store manifest/shard format is path-string-keyed, so pointing
``ViewStoreReader`` at a distributed filesystem only needs the IO layer
swapped: a pluggable opener registry keyed by URL scheme.  Bare paths
and ``file://`` resolve to the local filesystem; a ``gs://`` / ``s3://``
/ ``hdfs://`` backend registers a :class:`StoreFS` implementation once
and every reader, worker and coordinator path works unchanged::

    from repro_torch.store.uri import StoreFS, register_scheme

    class GcsFS(StoreFS):
        def open(self, path, mode="rb"): ...
        def exists(self, path): ...

    register_scheme("gs", GcsFS())
    reader = ViewStoreReader("gs://bucket/corpus")

Remote backends only need ``open``/``exists``: the base class reads
whole objects and decodes ``.npy`` in memory (a remote read is a
network transfer either way; mmap is a local-FS optimization).

When `fsspec <https://filesystem-spec.readthedocs.io>`_ is importable,
the common remote schemes (``gs``, ``s3``, ``memory``, ...) are
auto-registered through :class:`FsspecFS` — a lazy adapter that only
instantiates the backend filesystem (and thus imports its SDK: gcsfs,
s3fs, ...) on first IO, so a missing SDK fails at first use with the
backend's own install hint rather than at import time.  Without fsspec
nothing changes: unregistered schemes keep raising the explicit
``register_scheme`` hint.
"""

from __future__ import annotations

import io
import os
import posixpath
from typing import BinaryIO, Dict, Tuple
from urllib.parse import urlsplit

import numpy as np


class StoreFS:
    """Minimal filesystem surface a view-store reader needs."""

    #: Whether :meth:`load_array` can honor ``mmap_mode`` (local files).
    #: A remote backend materializes arrays in memory regardless, so
    #: the reader must evict its shard cache instead of holding every
    #: shard it ever touched.
    supports_mmap = False

    def open(self, path: str, mode: str = "rb") -> BinaryIO:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def join(self, base: str, *parts: str) -> str:
        """URI path join (POSIX semantics keep the scheme prefix intact)."""
        return posixpath.join(base, *parts)

    def load_array(self, path: str, *, mmap_mode=None) -> np.ndarray:
        """Default for remote schemes: fetch the object and decode in
        memory (``mmap_mode`` is a local-FS optimization and ignored)."""
        with self.open(path) as f:
            return np.load(io.BytesIO(f.read()))


class LocalFS(StoreFS):
    """Bare paths and ``file://`` — the default backend."""

    supports_mmap = True

    def open(self, path: str, mode: str = "rb") -> BinaryIO:
        return open(path, mode)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def join(self, base: str, *parts: str) -> str:
        return os.path.join(base, *parts)

    def load_array(self, path: str, *, mmap_mode=None) -> np.ndarray:
        return np.load(path, mmap_mode=mmap_mode)


class FsspecFS(StoreFS):
    """``fsspec``-backed opener for remote object stores.

    Lazy on purpose: the adapter is registered for a scheme without
    touching fsspec's backend registry, and ``fsspec.filesystem`` (which
    imports the scheme's SDK — gcsfs for ``gs``, s3fs for ``s3``) runs
    only on first IO.  ``storage_options`` are forwarded verbatim
    (credentials, endpoints, anonymous access, ...).
    """

    supports_mmap = False

    def __init__(self, scheme: str, **storage_options):
        self.scheme = scheme.lower()
        self._options = dict(storage_options)
        self._fs = None

    @property
    def fs(self):
        if self._fs is None:
            try:
                import fsspec
            except ImportError as e:  # registered eagerly by a caller
                raise ImportError(
                    f"scheme {self.scheme!r} is backed by fsspec, which is "
                    "not installed") from e
            self._fs = fsspec.filesystem(self.scheme, **self._options)
        return self._fs

    def open(self, path: str, mode: str = "rb") -> BinaryIO:
        return self.fs.open(path, mode)

    def exists(self, path: str) -> bool:
        return self.fs.exists(path)


#: Remote schemes resolved through fsspec when it is importable —
#: the DFS backends the store was designed for plus fsspec's in-memory
#: filesystem (the test double).  Lazy: a scheme's SDK is imported on
#: first IO, so listing it here costs nothing when it's absent.
FSSPEC_SCHEMES = ("gs", "gcs", "s3", "s3a", "az", "abfs", "hdfs", "memory")


def _fsspec_available() -> bool:
    import importlib.util

    return importlib.util.find_spec("fsspec") is not None


_LOCAL = LocalFS()
_REGISTRY: Dict[str, StoreFS] = {}


def register_scheme(scheme: str, fs: StoreFS) -> None:
    """Make ``scheme://...`` store paths resolve through ``fs``
    (overrides any fsspec auto-registration for that scheme)."""
    _REGISTRY[scheme.lower()] = fs


def registered_schemes() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_store_path(path: str) -> Tuple[StoreFS, str]:
    """Split a store path into (filesystem, backend-native path).

    Bare paths, ``file://`` URIs and one-letter "schemes" (Windows
    drives) map to :class:`LocalFS`.  Explicitly registered schemes win;
    otherwise the common remote schemes fall through to a lazily
    constructed :class:`FsspecFS` when fsspec is installed.  Anything
    else must be :func:`register_scheme`-d.
    """
    parts = urlsplit(path)
    scheme = parts.scheme.lower()
    if scheme in ("", "file") or len(scheme) == 1:
        return _LOCAL, parts.path if scheme == "file" else path
    fs = _REGISTRY.get(scheme)
    if fs is None and scheme in FSSPEC_SCHEMES and _fsspec_available():
        fs = _REGISTRY[scheme] = FsspecFS(scheme)
    if fs is None:
        hint = (f" (fsspec would resolve it — pip install fsspec)"
                if scheme in FSSPEC_SCHEMES else "")
        raise KeyError(
            f"no opener registered for scheme {scheme!r} (store path "
            f"{path!r}); call repro_torch.store.uri.register_scheme({scheme!r}, fs) "
            f"with a StoreFS implementation{hint}. Registered: "
            f"{registered_schemes() or '(none)'}")
    return fs, path
