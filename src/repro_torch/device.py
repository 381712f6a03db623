"""Device resolution for every entry point of the port.

The port runs on the card unless the caller asks for the host: a
request for ``"cuda"`` on a host without CUDA raises instead of quietly
running the plain versions on the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """The ``torch.device`` for ``device``; raises when CUDA is asked
    for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"repro_torch: device {str(device)!r} requested but CUDA is not "
            "available on this host; pass device='cpu' to run the plain "
            "PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', not {dev.type!r}")
    return dev
