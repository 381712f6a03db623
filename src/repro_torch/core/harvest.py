"""Activation harvesting: the bridge between the model zoo and the
paper's technique.

Port of ``repro/core/harvest.py``.  RandomizedCCA consumes paired views
(n × d matrices).  This module turns a zoo model into a view provider:
run the backbone over a token stream and emit per-position hidden states
as CCA rows, in f32 on the model's device, where the streaming fit
(:func:`repro_torch.core.rcca.randomized_cca_iterator`) folds them
without a copy to the host.  Two LMs over the same tokens give the two
views (``examples/activation_cca_torch.py``); two depths of one model
give SVCCA-style views (:func:`layer_views`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def activation_views(model, batch: Dict[str, torch.Tensor], *, normalize: bool = True,
                     depth: Optional[int] = None) -> torch.Tensor:
    """Final-layer hidden states flattened to f32 CCA rows (B·S, D) (those
    after the first ``depth`` layers when it is given).

    ``normalize`` applies per-row unit-variance scaling, the analogue of
    the paper's per-view scale-free regularization setup.
    """
    hidden = model.forward_hidden(batch, depth=depth)
    B, S, D = hidden.shape
    rows = hidden.reshape(B * S, D).float()
    if normalize:  # jnp.std: the population form (ddof = 0)
        rows = rows / (torch.std(rows, dim=1, keepdim=True, correction=0) + 1e-6)
    return rows


def paired_activation_stream(model_a, model_b, token_batches):
    """Iterator of (A_chunk, B_chunk) view pairs for the streaming CCA
    driver — one chunk per token batch (``{"tokens": (B, S)}``), computed
    lazily (out-of-core)."""
    for batch in token_batches:
        yield activation_views(model_a, batch), activation_views(model_b, batch)


def layer_views(model, batch: Dict[str, torch.Tensor], layer_frac: float) -> torch.Tensor:
    """SVCCA-style: hidden states at a fractional depth (the first
    max(1, ⌊L·layer_frac⌋) layers), normalized as :func:`activation_views`."""
    keep = max(1, int(model.cfg.n_layers * layer_frac))
    return activation_views(model, batch, depth=keep)
