#!/usr/bin/env python3
"""Where the zoo's full-width serving and harvesting spend their time.

    PYTHONPATH=src python3 scripts/zoo_profile.py      # one CUDA card

granite-3-2b at full width in bf16 (random weights from seed 0): two
prefills of a batch of 8 × 512 tokens (cold, then warm), three decode
steps timed on the host (enqueue, then to a device sync), then
``torch.profiler`` over three decode steps, one prefill, and one
harvested chunk (``activation_views`` of the same 8 × 512 tokens) of
granite-3-2b and of gemma3-1b.  Prints each table by device time and,
per decode step, the CUDA launches, the host's time and the device's.
Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

B, S, STEPS = 8, 512, 3


def _ms_since(t0: float) -> float:
    import torch

    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def _profile(fn):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    launches = sum(e.count for e in ev if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    # the kernels' own events, as the table's "Self CUDA time total" sums them
    device_ms = sum(e.self_device_time_total for e in ev if e.device_type == DeviceType.CUDA) / 1e3
    return ev, launches, device_ms


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("zoo_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core.harvest import activation_views
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cfg = get_config("granite-3-2b")
    model = build_model(cfg, device=dev)
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, S), np.int32))
    tok = tok.to(dev)
    cache = model.init_cache(B, S + 8 + 4 * STEPS)
    for label in ("cold", "warm"):
        cache.pos = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.prefill(tok, cache)
        print(f"[zoo] prefill {B} × {S} ({label}): {_ms_since(t0):.1f} ms", flush=True)
    nxt = torch.argmax(logits[:, -1:], -1)
    for i in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.decode_step(nxt, cache)
        enq = 1e3 * (time.perf_counter() - t0)
        print(f"[zoo] decode step {i}: host enqueue {enq:.2f} ms, to sync {_ms_since(t0):.2f} ms",
              flush=True)

    def steps():
        for _ in range(STEPS):
            model.decode_step(nxt, cache)

    t0 = time.perf_counter()
    ev, launches, device_ms = _profile(steps)
    print(f"[zoo] decode under the profiler: {launches / STEPS:.0f} CUDA launches a step, "
          f"{_ms_since(t0) / STEPS:.2f} ms a step on the host clock, {device_ms / STEPS:.2f} ms "
          "a step of device time", flush=True)
    print(ev.table(sort_by="self_cuda_time_total", row_limit=15), flush=True)
    cache.pos = 0
    ev, launches, device_ms = _profile(lambda: model.prefill(tok, cache))
    print(f"[zoo] prefill under the profiler: {launches} CUDA launches, {device_ms:.2f} ms of "
          "device time", flush=True)
    print(ev.table(sort_by="self_cuda_time_total", row_limit=12), flush=True)
    del cache, logits
    for name, m in (("granite-3-2b", model),
                    ("gemma3-1b", build_model(get_config("gemma3-1b"), device=dev, seed=1))):
        for i in range(3):
            t0 = time.perf_counter()
            activation_views(m, {"tokens": tok})
            print(f"[zoo] harvest {name} {B} × {S} ({i}): {_ms_since(t0):.1f} ms", flush=True)
        ev, launches, device_ms = _profile(lambda: activation_views(m, {"tokens": tok}))
        print(f"[zoo] harvest {name} under the profiler: {launches} CUDA launches, "
              f"{device_ms:.2f} ms of device time", flush=True)
        print(ev.table(sort_by="self_cuda_time_total", row_limit=12), flush=True)
        del m
    return 0


if __name__ == "__main__":
    sys.exit(main())
