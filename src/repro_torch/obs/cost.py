"""The launch-plan cost model behind the trace's roofline (port of
``repro/obs/cost.py``).

The port's launch plans (:mod:`repro_torch.kernels.plan`) are the one
source of a launch's geometry, and :func:`repro_torch.kernels.ops.chunk_cost`
already sums them per chunk update: FLOPs as the kernels do them (the
staged schedules' projection once, the recompute schedules' projection
per bucket) and bytes as each launch's inputs read once and outputs
written once.  The reference's ``plan_bytes`` modelled Pallas's VMEM
residency runs, a TPU's, and has no counterpart here.

:func:`chunk_cost_fn` is what the fold loops call: a cheap ``(a, b) ->
cost`` closure over the pass kind, or None when tracing is off or the
engine is ``torch`` (its launches are PyTorch's and carry no cost).
The cost's ``entries`` are ``ops.chunk_cost``'s, per entry point under
the names the launch counters use (``proj_stage``,
``powerpass_sweep[bf16,f32]``, ...), so a trace's ``kernel_cost`` calls
equal ``ops.launch_counts()``.  The summing helper
:func:`merge_kernel_costs` is the cost model's own
(:mod:`repro_torch.kernels.ops`); this module loads the kernel layer.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ..kernels import ops
from ..kernels.ops import merge_kernel_costs  # noqa: F401  (the fold loops sum with it)
from . import trace


def chunk_cost_fn(kind: str, engine: str, kt: int, dtype: Any,
                  seeded: bool = False) -> Optional[Callable]:
    """``(a, b) -> {"flops", "bytes", "entries", "schedule"}`` for one
    chunk update of pass ``kind`` on operands of torch dtype ``dtype``,
    or None when tracing is off or ``engine`` is not ``"kernels"``.  The
    closure reads shapes only; the model is memoized per shape
    (``ops.chunk_cost``), so a traced chunk costs a cache lookup."""
    if not trace.enabled() or engine != "kernels":
        return None

    def fn(a: Any, b: Any) -> Dict[str, Any]:
        c = ops.chunk_cost(kind, int(a.shape[0]), int(a.shape[1]), int(b.shape[1]), int(kt),
                           engine=engine, seeded=seeded, dtype=dtype)
        return {"flops": c["flops"], "bytes": c["bytes"], "entries": c["entries"],
                "schedule": c["schedule"]}

    return fn
