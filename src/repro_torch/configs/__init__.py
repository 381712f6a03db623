"""Workload configurations (port of ``repro.configs``)."""
