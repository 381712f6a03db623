"""``python -m repro_torch.analysis``: the port's static-analysis gate.

With no subcommand it runs the full gate: the architecture lint over
``src/repro_torch``, the kernel contracts over every registered form (on
the card: its kernels and the occupancy API; with ``--device cpu``
before any subcommand, the plain versions; RCCA107 reported as not run),
and the cluster protocol's interleaving exploration.  It prints
``ANALYZE: OK`` or ``ANALYZE: FAIL`` and exits 0 only when everything is
clean.

Subcommands::

    lint [paths...]             architecture lint (default: the whole package)
    kernels [--device cpu]      kernel contracts: on the card by default (a
                                host without CUDA raises); --device cpu
                                holds the plans against the plain versions
    protocol [--trace FILE]     trace invariants (FILE or
                                $RCCA_PROTOCOL_TRACE) and the exploration
    sanitize-diff A B           compare two RCCA_SANITIZE_OUT traces and
                                name the first merge boundary where they part
"""

from __future__ import annotations

import argparse
import os
import sys

from .report import render_report


def _run_lint(paths) -> int:
    from .lint import PACKAGE, lint_file, lint_tree

    if paths:
        vs = []
        for p in paths:
            # the source root above the package, so rule scoping sees repro_torch/...
            ap = os.path.abspath(p)
            root = ap
            while os.path.basename(os.path.dirname(root)) and os.path.basename(root) != PACKAGE:
                root = os.path.dirname(root)
            vs.extend(lint_file(ap, os.path.dirname(root)))
    else:
        vs = lint_tree()
    print(render_report(vs, title="architecture lint (RCCA0xx)"))
    return 1 if vs else 0


def _run_kernels(device: str = "cuda") -> int:
    from .kernel_check import RCCA107_NOTE, check_registry

    lines: list = []
    vs = check_registry(device=device, report=lines.append)
    for line in lines:
        print(f"  occupancy: {line}")
    print(render_report(vs, title=f"kernel contracts (RCCA1xx) on {device}"))
    print(f"  {RCCA107_NOTE}")
    return 1 if vs else 0


def _run_protocol(trace: str | None) -> int:
    from .protocol import check_trace_file, explore_interleavings

    vs = list(check_trace_file(trace))
    report = explore_interleavings()
    vs.extend(report.violations())
    print(render_report(vs, title="cluster protocol (RCCA2xx)"))
    print(f"  model: {report.n_scenarios} crash scenarios, "
          f"{report.n_interleavings} interleavings explored")
    return 1 if vs else 0


def _run_sanitize_diff(a: str, b: str) -> int:
    from .sanitize import first_divergence, load

    div = first_divergence(load(a), load(b))
    if div is None:
        print("sanitize traces identical")
        return 0
    print(f"RCCA301 first divergence at record {div['index']} ({div['reason']}):")
    print(f"  a: {div['a']}")
    print(f"  b: {div['b']}")
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the full gate's kernel contracts run (default: the card)")
    sub = ap.add_subparsers(dest="cmd")
    p_lint = sub.add_parser("lint", help="architecture lint")
    p_lint.add_argument("paths", nargs="*")
    p_kern = sub.add_parser("kernels", help="kernel contracts")
    p_kern.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p_proto = sub.add_parser("protocol", help="protocol trace and model check")
    p_proto.add_argument("--trace", default=None)
    p_diff = sub.add_parser("sanitize-diff", help="compare sanitize traces")
    p_diff.add_argument("a")
    p_diff.add_argument("b")
    args = ap.parse_args(argv)

    if args.cmd == "lint":
        return _run_lint(args.paths)
    if args.cmd == "kernels":
        return _run_kernels(args.device)
    if args.cmd == "protocol":
        return _run_protocol(args.trace)
    if args.cmd == "sanitize-diff":
        return _run_sanitize_diff(args.a, args.b)
    rc = _run_lint([])
    rc |= _run_kernels(args.device)
    rc |= _run_protocol(None)
    print("ANALYZE: " + ("FAIL" if rc else "OK"))
    return rc


if __name__ == "__main__":
    sys.exit(main())
