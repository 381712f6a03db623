"""Cluster-protocol checking (port of the recording half of
``repro.analysis``): :func:`trace_event` records the partial store's and
the coordinator's protocol events, :func:`check_trace` holds a recorded
sequence to RCCA201-204.  The reference's explorer, lint, kernel checker
and sanitizer are not ported (ROADMAP Queue 1 item 5)."""

from .protocol import check_trace, trace_event
from .report import Violation

__all__ = ["Violation", "check_trace", "trace_event"]
