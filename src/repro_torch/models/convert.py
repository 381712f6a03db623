"""Carry the reference's parameters into the port's modules.

The reference's ``LMModel.init`` returns a pytree whose ``layers``
entries are stacked over the layers (its scan's layout).  The port holds
one module a layer with the same parameter names and (in, out) layout,
so loading is unstacking: ``tree["layers"][name][l]`` goes to
``model.layers[l]``'s ``name``.  With the same weights both packages
compute the same function, which is how the tests hold the port to the
reference.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..dtypes import as_tensor, storage_dtype


def _flatten(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield prefix + key, val


def _tensor(arr) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if str(arr.dtype) == "bfloat16":  # ml_dtypes' bf16: carried as its bits
        return as_tensor(arr.view(storage_dtype("bfloat16")), "bfloat16")
    return torch.tensor(arr)


def from_jax_params(model: torch.nn.Module, tree: Mapping) -> torch.nn.Module:
    """Load the reference's ``init`` tree (arrays numpy can hold) into
    ``model`` in place, every parameter named once (``strict``), each
    cast to the model's dtype and device.  Returns ``model``."""
    state = {}
    for name, arr in _flatten({k: v for k, v in tree.items() if k != "layers"}):
        state[name] = _tensor(arr)
    for name, arr in _flatten(tree["layers"]):
        arr = np.asarray(arr)
        if arr.shape[0] != len(model.layers):
            raise ValueError(f"layers.{name}: {arr.shape[0]} layers stacked, "
                             f"the model has {len(model.layers)}")
        for i in range(arr.shape[0]):
            state[f"layers.{i}.{name}"] = _tensor(arr[i])
    model.load_state_dict(state, strict=True)
    return model
