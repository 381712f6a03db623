"""Blockwise int8 compression with error feedback for all-reduces.

Port of ``repro/distributed/compress.py``.  The quantization residual is
carried to the next round, so compression noise averages out instead of
biasing the solve.  The sharded fit uses it for the (mb × k̃) partial-P
sum over the model axis (``collective="fused-int8ef"``) and, under
``int8_reduce``, for the end-of-pass Y sum over the row axes.

Rounding is half to even, as ``jnp.round`` rounds; ``torch.round`` does
the same, so :func:`int8_encode` and :func:`int8_decode` give the
reference's bits on the same f32 input.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """x (..., d) zero-padded to a multiple of ``block`` and viewed as
    (..., ⌈d / block⌉, block)."""
    d = x.shape[-1]
    pad = (-d) % block
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], -1, block)


def int8_encode(x: torch.Tensor, block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization along the last axis.

    Returns (q: int8, scales: f32 with last dim ⌈d / block⌉)."""
    xb = _blocks(x, block)
    scale = torch.clamp(xb.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-30)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def int8_decode(q: torch.Tensor, scale: torch.Tensor, d: int) -> torch.Tensor:
    """The f32 values of :func:`int8_encode`'s blocks, cut back to d
    columns (row-major, as the kernels take them)."""
    xb = q.to(torch.float32) * scale[..., None]
    return xb.reshape(*xb.shape[:-2], -1)[..., :d].contiguous()


def psum_int8_ef(x: torch.Tensor, group, err: Optional[torch.Tensor] = None, *,
                 block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Compressed all-reduce over ``group`` with error feedback.

    x: this rank's contribution; err: the residual of the previous call
    (x's shape).  Returns (approximate sum over the group, new residual).

    Every rank requantizes its dequantized contribution against the
    group's largest block scale (an ``all_reduce(MAX)`` of the scales), so
    the int32 sum of the payloads (``all_reduce(SUM)``, exact) decodes
    with one scale per block.  ``group=None`` is a group of this rank
    alone: no collective is issued.
    """
    if err is not None:
        x = x + err
    d = x.shape[-1]
    q, scale = int8_encode(x, block)
    gscale = scale.clone()
    if group is not None:
        dist.all_reduce(gscale, op=dist.ReduceOp.MAX, group=group)
    xq = int8_decode(q, scale, d)  # the dequantized local value, as sent
    q2 = torch.clamp(torch.round(_blocks(xq, block) / gscale[..., None]), -127, 127)
    new_err = x - int8_decode(q2.to(torch.int8), gscale, d)
    total = q2.to(torch.int32)
    if group is not None:
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return int8_decode(total, gscale, d), new_err
