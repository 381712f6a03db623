"""Bucketed all-reduce of the end-of-pass accumulator.

Port of ``repro/distributed/overlap.py``.  The d × k̃ accumulator's sum
over the row axes is the one large collective of a pass;
:func:`bucketed_accumulate` splits it into column buckets and issues one
asynchronous ``all_reduce`` per bucket before waiting on any, so the
backend may overlap their transfers.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist


def bucketed_accumulate(contributions: Union[torch.Tensor, Sequence[torch.Tensor]], group,
                        n_buckets: int = 4) -> torch.Tensor:
    """The sum over ``group`` of an accumulator, reduced in column buckets.

    contributions: the accumulator, or a list of partial accumulators
    that are summed first.  ``group=None`` is this rank alone."""
    acc = (contributions if isinstance(contributions, torch.Tensor)
           else sum(contributions[1:], contributions[0]))
    k = acc.shape[1]
    n_buckets = max(1, min(n_buckets, k))
    bsz = -(-k // n_buckets)
    outs = [acc[:, b * bsz:min((b + 1) * bsz, k)].contiguous() for b in range(n_buckets)]
    if group is not None:
        works = [dist.all_reduce(o, group=group, async_op=True) for o in outs]
        for w in works:
            w.wait()
    return torch.cat(outs, dim=1)
