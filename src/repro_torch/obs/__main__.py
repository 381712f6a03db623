"""CLI: ``python -m repro_torch.obs {report,export-trace} ...``."""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m repro_torch.obs {report,export-trace} [args...]\n"
              "  report        timeline + roofline from an RCCA_TRACE dir\n"
              "  export-trace  RCCA_TRACE dir -> chrome://tracing JSON\n"
              "  trajectory    not ported: the port has no benchmark artifacts yet")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "report":
        from .report import main as run
    elif cmd == "export-trace":
        from .chrometrace import main as run
    elif cmd == "trajectory":
        print("trajectory folds results/BENCH_*.json, and the port has no benchmark artifacts "
              "yet: it comes with the port's benchmark entry (ROADMAP Queue 1 item 2)")
        return 2
    else:
        print(f"unknown subcommand {cmd!r} (expected report or export-trace)")
        return 2
    return run(rest)


if __name__ == "__main__":
    raise SystemExit(main())
