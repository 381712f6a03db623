#!/usr/bin/env python3
"""Measures the determinism sanitizer's cost at Europarl width.  Needs one
CUDA card:

    PYTHONPATH=src python3 scripts/sanitize_cost.py

Runs ``cca_fit`` at Europarl width (da = db = 2^19, k = 60, p = 2000,
q = 1) over ``chip_smoke.PAIR_CHUNKS`` = 2 chunks of 8192 rows, the
seeded ≡ seeded-materialized pair of ``chip_smoke.py`` phase 7, in the
order seeded unsanitized, seeded sanitized, seeded-materialized
sanitized, seeded-materialized unsanitized (``sanitize.override`` turns
the sanitizer on in this process, as ``RCCA_SANITIZE=1`` would).  Prints
each fit's wall and pass seconds, the sanitizer's records, the bytes
each observation digests and the seconds it took (the copies to the host
and sha256, timed around ``sanitize.digest`` once the card has finished
the work queued before it), and each mode's sanitized wall less its
unsanitized one.  Exits non-zero unless the two modes'
sanitized traces are identical record for record, every fit's ρ and Xa
are the bits of the others' (the sanitizer moves no number), and each
trace holds one merge group and one ``pass_end`` a pass.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.analysis import sanitize  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

_digest = sanitize.digest
SPENT: list = []  # (seconds, bytes) of each observation's digest


def timed_digest(tree) -> str:
    """``sanitize.digest``, timed from the moment the card has done the work
    queued before it (the fold's last kernels are not the digest's)."""
    nbytes = sum(t.numel() * t.element_size() for _, t in sanitize._leaves(tree))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = _digest(tree)
    SPENT.append((time.perf_counter() - t0, nbytes))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("sanitize_cost.py needs a CUDA card")
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    sanitize.digest = timed_digest  # observe() digests through the module's name
    pair = ["--device", "cuda", "--n-chunks", str(cs.PAIR_CHUNKS), "--seed", str(cs.SEED)]
    runs = {}
    for mode, on in (("seeded", False), ("seeded", True), ("seeded-materialized", True),
                     ("seeded-materialized", False)):
        label = f"omega={mode}, sanitizer {'on' if on else 'off'}"
        del SPENT[:]
        with sanitize.override(on):
            rep, _, _, wall = cs.run_fit(pair + ["--omega", mode], label)
        trace = rep.result.diagnostics.get("sanitize")
        digests = (cs.digest(rep.result.rho), cs.digest(rep.result.Xa))
        runs[mode, on] = {"wall": wall, "trace": trace, "digests": digests,
                          "spent": list(SPENT)}
        if on:
            print(f"[sanitize] {label}: {len(trace)} records "
                  f"{[(r['pass_idx'], r['label'], r['digest'][:12]) for r in trace]}; per "
                  f"observation (GB, s): {[(round(b / 1e9, 3), round(s, 3)) for s, b in SPENT]}; "
                  f"digest s in all {sum(s for s, _ in SPENT):.3f}, "
                  f"{sum(b for _, b in SPENT) / 1e9 / max(1e-9, sum(s for s, _ in SPENT)):.3f} "
                  "GB/s", flush=True)
        del rep
        torch.cuda.empty_cache()
    for mode in ("seeded", "seeded-materialized"):
        print(f"[sanitize] omega={mode}: sanitized wall {runs[mode, True]['wall']:.3f} s less "
              f"unsanitized {runs[mode, False]['wall']:.3f} s = "
              f"{runs[mode, True]['wall'] - runs[mode, False]['wall']:.3f} s", flush=True)
    a, b = runs["seeded", True]["trace"], runs["seeded-materialized", True]["trace"]
    checks = {
        "traces identical": sanitize.first_divergence(a, b) is None,
        "one group and pass_end a pass": [(r["pass_idx"], r["label"]) for r in a] == [
            (0, "group:0"), (0, "pass_end"), (1, "group:0"), (1, "pass_end")],
        "rho, Xa equal in every fit": len({r["digests"] for r in runs.values()}) == 1,
        "no trace unsanitized": all(runs[m, False]["trace"] is None
                                    for m in ("seeded", "seeded-materialized")),
    }
    print(f"[sanitize] {checks}", flush=True)
    print(cs.card_line(), flush=True)
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
