"""Logical dtype names and the bits numpy stores them as.

The view store (``store/format.py``) and the checkpoints
(``ckpt/checkpoint.py``) keep tensors as ``.npy`` files, as the
reference does.  numpy has no bf16 (or f8) type, so such tensors are
stored as their bits in the unsigned integer of the same width, with the
logical dtype's name beside them; torch reads the bits back through a
view.  No numpy extension type is needed.
"""

from __future__ import annotations

import numpy as np
import torch

#: Logical dtypes kept as same-width unsigned integers on disk (numpy has
#: no such type), with the torch dtype their bits are read back as.
EXOTIC = {"bfloat16": (np.uint16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
          "float8_e5m2": (np.uint8, torch.float8_e5m2)}
#: The signed integer type of the same width: torch views bits through it.
_SIGNED = {np.dtype(np.uint16): (np.int16, torch.int16), np.dtype(np.uint8): (np.int8, torch.int8)}


def logical_name(dtype) -> str:
    """Manifest name of a dtype: ``"float32"``, ``"bfloat16"``, … (a torch
    dtype, numpy dtype or name)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if str(dtype) in EXOTIC:
        return str(dtype)
    return str(np.dtype(dtype))


def storage_dtype(logical: str) -> np.dtype:
    """The numpy dtype a logical dtype is stored as."""
    return np.dtype(EXOTIC[logical][0] if logical in EXOTIC else logical)


def torch_dtype(logical: str) -> torch.dtype:
    """The torch dtype of a logical dtype name."""
    if logical in EXOTIC:
        return EXOTIC[logical][1]
    return torch.from_numpy(np.zeros(0, np.dtype(logical))).dtype


def bits_view(t: torch.Tensor) -> np.ndarray:
    """A numpy view of a CPU tensor's elements in the storage dtype (a
    bf16 tensor as ``uint16``): writing it writes the tensor."""
    name = logical_name(t.dtype)
    if name not in EXOTIC:
        return t.numpy()
    store = storage_dtype(name)
    return t.view(_SIGNED[store][1]).numpy().view(store)


def as_tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    """A CPU tensor in ``logical`` dtype holding a copy of ``arr`` (rows
    in the storage dtype, e.g. a slice of a shard's memory map)."""
    out = torch.empty(arr.shape, dtype=torch_dtype(logical))
    np.copyto(bits_view(out), arr, casting="no")
    return out
