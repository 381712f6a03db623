"""The violation record of the protocol checker (port of the
``Violation`` of ``repro/analysis/report.py``).

The reference's checkers share it under code ranges (RCCA0xx lint,
RCCA1xx kernel checker, RCCA2xx cluster protocol, RCCA3xx sanitizer);
the port has the protocol checker only.  The class keeps the reference's
name and fields, so ``str(v)`` of the two packages' findings on one
trace is the same text.
"""

from __future__ import annotations

import dataclasses


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
