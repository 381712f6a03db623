"""The violation record every checker of :mod:`repro_torch.analysis`
emits, and its rendering (port of ``repro/analysis/report.py``).

Each checker keeps the reference's code range:

  RCCA0xx  architecture lint          (:mod:`.lint`)
  RCCA1xx  kernel contract checker    (:mod:`.kernel_check`)
  RCCA2xx  cluster protocol           (:mod:`.protocol`)
  RCCA3xx  determinism sanitizer      (:mod:`.sanitize`)

The class keeps the reference's name and fields, so ``str(v)`` of the
two packages' findings on one input is the same text.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding: a stable rule code, where, and why."""

    code: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.code} {self.message}"


def render_report(violations: Sequence[Violation], *, title: str) -> str:
    """Title, the findings sorted by place, and a count line."""
    lines = [title]
    for v in sorted(violations, key=lambda v: (v.path, v.line, v.code)):
        lines.append("  " + v.render())
    n = len(violations)
    lines.append(f"  -> {n} violation{'s' if n != 1 else ''}" if n else "  -> clean")
    return "\n".join(lines)
