"""repro_torch.obs: spans, counters and the roofline account of a fit
(port of ``repro.obs``).

* :mod:`repro_torch.obs.trace`: spans and counters as ``O_APPEND`` JSONL
  per process, on when ``RCCA_TRACE`` is set (one environment lookup
  when it is not), device spans timed by CUDA events on the card, and
  the pass-path clocks :func:`monotonic` / :func:`wall`;
* :mod:`repro_torch.obs.cost`: the launch-plan cost model behind the
  per-chunk ``flops`` / ``bytes`` and the ``kernel_cost`` counters;
* :mod:`repro_torch.obs.report`: ``python -m repro_torch.obs report
  <trace>``: timeline, coverage, roofline, io overlap, merge share,
  liveness, redispatches, protocol verdict;
* :mod:`repro_torch.obs.chrometrace`: ``python -m repro_torch.obs
  export-trace``: the trace as Chrome trace-event JSON (Perfetto).

The reference's ``trajectory`` (its benchmark artifacts' history) is not
ported: the port has no benchmark artifacts yet (ROADMAP, the benchmark
entry).

Instrumented modules do ``from .. import obs`` and call ``obs.span`` /
``obs.device_span`` / ``obs.counter`` / ``obs.monotonic``; the heavier
submodules load on first attribute access.
"""
from __future__ import annotations

import importlib

from .trace import (  # noqa: F401
    DEFAULT_DIR,
    TRACE_ENV,
    close,
    counter,
    device_span,
    enabled,
    iter_events,
    load_events,
    monotonic,
    proto_event,
    set_context,
    span,
    trace_dir,
    wall,
)

_SUBMODULES = ("trace", "cost", "report", "chrometrace")


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "TRACE_ENV", "DEFAULT_DIR", "close", "span", "device_span", "counter", "enabled", "trace_dir",
    "set_context", "proto_event", "monotonic", "wall", "iter_events",
    "load_events", *_SUBMODULES,
]
