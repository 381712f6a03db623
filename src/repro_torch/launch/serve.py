"""Batched serving driver: prefill a prompt batch, decode N tokens.

Port of ``repro/launch/serve.py`` for the dense attention family:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --smoke \
        --batch 4 --prompt-len 32 --gen 16 --device cpu

Prefill runs the prompt through ``LMModel.prefill`` (one step at S =
prompt length, filling the KV cache), then greedy decode one token a
step.  The model lives on one device, so the reference's mesh and
parameter shardings have no counterpart.  Weights are drawn from a
``torch.Generator`` seeded with the reference's ``PRNGKey(0)`` seed, 0:
the same distribution, not the same bits, so the generated tokens are
not compared across packages (the tests carry weights across instead).

Beyond the reference's flags: ``--device`` (the card by default; ``cpu``
runs on the host, and a host without CUDA raises unless it is given).
Times are host clocks around work that ends in a device sync; on the
card the peak device memory is printed beside them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import DEFAULT_DEVICE, resolve_device
from ..models import build_model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu; no quiet fallback to the host")
    args = ap.parse_args(argv)
    if args.gen < 1:
        raise ValueError("--gen must be at least 1")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=dev, seed=0)
    B = args.batch
    max_seq = min(cfg.max_seq, args.prompt_len + args.gen + 8)

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (B, args.prompt_len), np.int32))
    prompts = prompts.to(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    _sync(dev)
    t0 = time.perf_counter()
    cache = model.init_cache(B, max_seq)
    logits, cache = model.prefill(prompts, cache)
    tok = torch.argmax(logits[:, -1:], -1)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        logits, cache = model.decode_step(tok, cache)
        tok = torch.argmax(logits[:, -1:], -1)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    gen = torch.cat(out, dim=1)
    if not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
        raise RuntimeError(f"{cfg.name}: a generated token is outside [0, {cfg.vocab})")
    steps = args.gen - 1
    tput = B * steps / max(t_decode, 1e-9)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    print(f"[serve] arch={cfg.name} prefill {t_prefill*1e3:.0f} ms, "
          f"decode {t_decode*1e3:.0f} ms ({tput:.1f} tok/s), sample {gen[0, :8].tolist()}")
    print(f"[serve] on {where}: {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters in {cfg.dtype}, "
          f"batch {B}, prompt {args.prompt_len}, {steps} decode steps of "
          f"{t_decode * 1e3 / max(steps, 1):.2f} ms each"
          + (f", peak device memory {peak:.2f} GB" if peak is not None else ""), flush=True)
    return {"arch": cfg.name, "device": where, "tokens": gen.cpu(),
            "prefill_ms": t_prefill * 1e3, "decode_ms": t_decode * 1e3,
            "decode_ms_per_step": t_decode * 1e3 / max(steps, 1), "tok_s": tput,
            "peak_gb": peak}


if __name__ == "__main__":
    main()
