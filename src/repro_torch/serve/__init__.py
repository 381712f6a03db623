"""Model serving: versioned CCA artifacts, batched projection, drift
(port of ``repro.serve``).

The serving half of the incremental-fit path
(:mod:`repro_torch.exec.delta`):

- :class:`ModelRegistry` — versioned, atomically published,
  content-hashed model artifacts (:mod:`repro_torch.serve.registry`);
- :class:`BatchedProjector` — coalesces concurrent projection requests
  into padded device batches, with zero-drop hot swap between batches
  (:mod:`repro_torch.serve.projector`);
- :class:`CorpusIndex` — cross-view top-k retrieval against an indexed
  corpus of projected rows;
- :class:`DriftMonitor` — canonical-correlation decay on held-out
  traffic raises the refit-needed signal that feeds
  :func:`repro_torch.exec.delta_refit` (:mod:`repro_torch.serve.drift`).

``python -m repro_torch.launch.cca_serve`` drives the whole loop.  Under
``RCCA_TRACE`` (:mod:`repro_torch.obs`) the tier records the
``serve_batch`` and ``index_build`` spans and the ``serve_occupancy``,
``serve_swap``, ``drift``, ``drift_signal``, ``registry_publish`` and
``registry_prune`` counters.
"""

from .drift import DriftMonitor, paired_correlation
from .projector import BatchedProjector, CorpusIndex, project
from .registry import ModelRegistry, ServedModel

__all__ = [
    "BatchedProjector",
    "CorpusIndex",
    "DriftMonitor",
    "ModelRegistry",
    "ServedModel",
    "paired_correlation",
    "project",
]
