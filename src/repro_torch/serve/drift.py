"""Drift monitoring: canonical-correlation decay on held-out traffic.

Port of ``repro/serve/drift.py``.  A served CCA model claims its
projections correlate across views: on paired traffic (xa, xb) the
per-component Pearson correlation of φᵃ(xa) and φᵇ(xb) should track the
fitted canonical correlations.  When the traffic's distribution moves,
that correlation decays — a health signal computable from a small
held-out sample with no labels.

:class:`DriftMonitor` keeps a window of paired held-out rows.  The first
full window under a model version becomes the baseline; every later full
window's mean top-k correlation is compared against it, and a relative
decay below ``threshold`` latches the refit-needed signal (a flag and an
optional callback) that the serving loop feeds into
:func:`repro_torch.exec.delta_refit`.  ``rebind(model)`` after a hot
swap re-baselines on fresh traffic.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Optional

import numpy as np

from .. import obs
from .projector import _engine, project
from .registry import ServedModel


def paired_correlation(model: ServedModel, xa, xb, engine: str = "kernels") -> np.ndarray:
    """Per-component Pearson correlation of the two views' projections
    over a sample of paired rows — the empirical counterpart of the
    fitted canonical correlations ρ.  The rows are projected as the
    projector projects them (:func:`~repro_torch.serve.projector.project`);
    the statistics are the reference's, in f32 on the host."""
    ea = model.project_a(xa, engine).cpu().numpy()
    eb = model.project_b(xb, engine).cpu().numpy()
    ea = ea - ea.mean(axis=0)
    eb = eb - eb.mean(axis=0)
    denom = np.sqrt((ea * ea).sum(axis=0) * (eb * eb).sum(axis=0))
    denom = np.where(denom == 0, 1.0, denom)
    return (ea * eb).sum(axis=0) / denom


class DriftMonitor:
    """Sliding-window correlation-decay detector (module docstring).

    ``observe(xa, xb)`` feeds paired held-out rows (single rows or
    blocks); each time the window holds ``window`` rows, the monitor
    evaluates and empties it.  ``refit_needed`` latches True once the
    mean correlation falls below ``threshold × baseline``; ``rebind``
    clears it for a refreshed model.
    """

    def __init__(self, model: ServedModel, *, window: int = 256, threshold: float = 0.8,
                 top: Optional[int] = None,
                 on_refit_needed: Optional[Callable[["DriftMonitor"], None]] = None,
                 engine: str = "kernels"):
        if not 0.0 < threshold <= 1.0:
            raise ValueError("threshold is a relative-decay fraction in (0, 1]")
        self.model = model
        self.window = int(window)
        self.threshold = float(threshold)
        self.top = top  # components tracked (default: all k)
        self.on_refit_needed = on_refit_needed
        self.engine = _engine(engine)
        self.baseline: Optional[float] = None
        self.last_mean: Optional[float] = None
        self.windows_evaluated = 0
        self.refit_needed = False
        self._rows_a: Deque[np.ndarray] = deque()
        self._rows_b: Deque[np.ndarray] = deque()

    # -- traffic ----------------------------------------------------------

    def observe(self, xa, xb) -> Optional[float]:
        """Feed paired held-out rows; returns the window's mean
        correlation when a window completed, else None."""
        xa = np.atleast_2d(np.asarray(xa, dtype=np.float32))
        xb = np.atleast_2d(np.asarray(xb, dtype=np.float32))
        if xa.shape[0] != xb.shape[0]:
            raise ValueError("held-out rows must stay paired")
        for i in range(xa.shape[0]):
            self._rows_a.append(xa[i])
            self._rows_b.append(xb[i])
        if len(self._rows_a) < self.window:
            return None
        return self._evaluate()

    def _evaluate(self) -> float:
        A = np.stack(self._rows_a)
        B = np.stack(self._rows_b)
        self._rows_a.clear()
        self._rows_b.clear()
        corr = paired_correlation(self.model, A, B, self.engine)
        top = self.top if self.top is not None else corr.shape[0]
        mean = float(np.mean(corr[:top]))
        self.last_mean = mean
        self.windows_evaluated += 1
        if self.baseline is None:
            self.baseline = mean
            obs.counter("drift", version=self.model.version, mean=mean, baseline=mean, ratio=1.0)
            return mean
        ratio = mean / self.baseline if self.baseline > 0 else 1.0
        obs.counter("drift", version=self.model.version, mean=mean, baseline=self.baseline,
                    ratio=ratio)
        if ratio < self.threshold and not self.refit_needed:
            self.refit_needed = True
            obs.counter("drift_signal", version=self.model.version, mean=mean,
                        baseline=self.baseline, ratio=ratio)
            if self.on_refit_needed is not None:
                self.on_refit_needed(self)
        return mean

    # -- lifecycle --------------------------------------------------------

    def rebind(self, model: ServedModel, *, keep_baseline: bool = False) -> None:
        """Point the monitor at a refreshed model (after a hot swap): the
        signal clears and, unless ``keep_baseline``, the next full window
        under the new version re-baselines."""
        self.model = model
        self.refit_needed = False
        self._rows_a.clear()
        self._rows_b.clear()
        if not keep_baseline:
            self.baseline = None

    def status(self) -> dict:
        return {
            "version": self.model.version, "baseline": self.baseline,
            "last_mean": self.last_mean, "refit_needed": self.refit_needed,
            "windows": self.windows_evaluated, "buffered": len(self._rows_a),
        }
