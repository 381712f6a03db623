"""Collectives of the sharded fit over ``torch.distributed`` (port of
``repro.distributed``)."""

from .compress import int8_decode, int8_encode, psum_int8_ef
from .overlap import bucketed_accumulate

__all__ = ["bucketed_accumulate", "int8_decode", "int8_encode", "psum_int8_ef"]
