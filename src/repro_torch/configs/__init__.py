"""Workload configurations (port of ``repro.configs``): the architecture
registry.

Each module exports ``config()`` (the exact published configuration)
and ``smoke_config()`` (a reduced same-family variant for CPU tests).
The registry names every architecture of the reference; the port holds
the modules of :data:`PORTED` and raises for the others (ROADMAP
Queue 1 item 6).
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "gemma3_1b",
    "starcoder2_7b",
    "gemma_7b",
    "granite_3_2b",
    "whisper_small",
    "kimi_k2_1t_a32b",
    "deepseek_v2_236b",
    "xlstm_350m",
    "zamba2_7b",
    "qwen2_vl_2b",
    # the paper's own workload as an 11th selectable config
    "europarl_cca",
]

#: The modules the port has: the dense attention family and the paper's
#: workload.
PORTED = ("gemma3_1b", "starcoder2_7b", "gemma_7b", "granite_3_2b", "europarl_cca")

# canonical CLI ids (dashes) → module names
CANONICAL = {a.replace("_", "-"): a for a in ARCH_IDS}


def get_module(arch: str):
    mod = CANONICAL.get(arch, arch).replace("-", "_")
    if mod in ARCH_IDS and mod not in PORTED:
        raise NotImplementedError(
            f"{arch}: its model family is not ported yet (ROADMAP Queue 1 item 6)")
    return importlib.import_module(f"{__name__}.{mod}")


def get_config(arch: str, smoke: bool = False):
    m = get_module(arch)
    return m.smoke_config() if smoke else m.config()


def model_archs() -> list[str]:
    """The LM archs the port builds (europarl_cca is a CCA workload, not
    an LM)."""
    return [a.replace("_", "-") for a in ARCH_IDS if a in PORTED and a != "europarl_cca"]
