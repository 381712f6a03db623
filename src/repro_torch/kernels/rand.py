"""Counter-based tile PRNG of the seeded-Ω path.

Port of ``repro/kernels/rand.py``.  Ω is a pure function of a seed and
the element's coordinates,

    Ω[i, j] = √(−2·log(2 − f0)) · cos(2π·(f1 − 1)),
    (b0, b1) = Threefry-2x32-20(key = seed, counter = (i, j)),
    f = bitcast_f32((b >> 9) | 0x3F800000) ∈ [1, 2),

and exactly 0 outside the logical (d, k̃).  So any tile of Ω can be made
where it is used, and a worker needs the 8-byte seed, not a 4.3 GB
(2^19, 2060) array.  The uint32 bits equal the reference's bitwise; the
f32 normals agree within a few ulp, because ``log`` and ``cos`` are
rounded differently by XLA, the host's libm and CUDA's libdevice.

Two versions of one function:

- the plain one here: :func:`normal_tile`, and :func:`omega_tile`,
  which makes a slab of Ω from it in row blocks on any device.
  ``torch.uint32`` has few operators, so the 32-bit arithmetic runs in
  int64 with masking.  ``log`` and ``cos`` are evaluated in
  float64 and rounded once to f32, which makes each f32 step correctly
  rounded but for the rare f64 result within an f64 ulp of an f32
  rounding boundary, and makes the element's value independent of where
  it falls in a vectorized loop;
- the CUDA one, ``csrc/rand.cuh`` ``normal_elem``, behind
  :func:`omega_fill` (precise ``logf``/``cosf``/``sqrtf``, no FMA
  contraction).

Ω in bf16 (the reference's ``q_dtype=bfloat16``) is the f32 element
rounded once to bf16, to nearest even: on the card ``omega_fill(...,
dtype=torch.bfloat16)`` rounds inside the generator (``omega_fill[bf16]``),
bitwise ``omega_fill(...).to(torch.bfloat16)``.  Where the two packages'
f32 elements differ by an ulp, their bf16 elements may differ by one bf16
ulp, rarely.

:func:`omega_seeds` derives the two per-view seeds from an integer seed
exactly as ``repro.kernels.rand.seeds_from_key(jax.random.PRNGKey(seed))``
does under ``jax_threefry_partitionable`` (jax ≥ 0.5): the key split and
the bits draw are themselves Threefry over iota counters.
"""

from __future__ import annotations

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from . import build

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TWO_PI_F32 = torch.tensor(6.283185307179586, dtype=torch.float32)

#: A per-view Ω seed: the two uint32 key words as Python ints.
Seed = tuple[int, int]


def _rot(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds: encrypt counter ``(c0, c1)`` under key
    ``(k0, k1)``.  Operands are Python ints or int64 tensors holding
    uint32 values; they broadcast elementwise."""
    ks2 = k0 ^ k1 ^ 0x1BD11BDA
    x0 = (c0 + k0) & M32
    x1 = (c1 + k1) & M32
    ks = (k0, k1, ks2)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rot(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _f12(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (in int64) → f32 in [1, 2) by exponent patching."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)


def normal_tile(s0: int, s1: int, r0: int, c0: int, shape, *, row_limit=None,
                col_limit=None, device=DEFAULT_DEVICE) -> torch.Tensor:
    """One f32 N(0, 1) tile of Ω(seed): element (i, j) of the tile is Ω's
    global element (r0 + i, c0 + j); 0.0 at or beyond ``row_limit`` /
    ``col_limit``.  The plain version, in PyTorch operators on
    ``device``."""
    device = resolve_device(device)
    rows = (torch.arange(shape[0], dtype=torch.int64, device=device) + r0) & M32
    cols = (torch.arange(shape[1], dtype=torch.int64, device=device) + c0) & M32
    b0, b1 = threefry2x32(s0, s1, rows[:, None], cols[None, :])
    f0 = _f12(b0)
    u1 = _f12(b1) - 1.0  # exact
    log = torch.log((2.0 - f0).double()).float()  # 2 - f0 exact (Sterbenz)
    r = torch.sqrt(-2.0 * log)
    c = torch.cos((_TWO_PI_F32.to(device) * u1).double()).float()
    z = r * c
    if row_limit is not None:
        z = torch.where(rows[:, None] < row_limit, z, 0.0)
    if col_limit is not None:
        z = torch.where(cols[None, :] < col_limit, z, 0.0)
    return z


#: Rows per block of :func:`omega_tile`: bounds its int64 temporaries
#: (~270 MB each at k̃ = 2060) when it runs on the card at Europarl width.
_PLAIN_BLOCK_ROWS = 16384


def omega_tile(seed: Seed, d: int, kt: int, *, r0: int = 0, rows: int | None = None,
               cols: int | None = None, device=DEFAULT_DEVICE) -> torch.Tensor:
    """The plain version of :func:`omega_fill`, in PyTorch operators on
    ``device``: rows [r0, r0 + rows) × columns [0, cols) of Ω(seed), 0.0
    outside (d, kt), made by :func:`normal_tile` in blocks of rows."""
    device = resolve_device(device)
    rows = d - r0 if rows is None else rows
    cols = kt if cols is None else cols
    out = torch.empty((rows, cols), dtype=torch.float32, device=device)
    for i in range(0, rows, _PLAIN_BLOCK_ROWS):
        n = min(_PLAIN_BLOCK_ROWS, rows - i)
        out[i:i + n] = normal_tile(seed[0], seed[1], r0 + i, 0, (n, cols),
                                   row_limit=d, col_limit=kt, device=device)
    return out


def omega_fill(seed: Seed, d: int, kt: int, *, r0: int = 0, rows: int | None = None,
               cols: int | None = None, dtype=torch.float32,
               device=DEFAULT_DEVICE) -> torch.Tensor:
    """Rows [r0, r0 + rows) of Ω(seed) over columns [0, cols): a (rows,
    cols) tensor of ``dtype`` (each element made in f32 and rounded once),
    0.0 outside the logical (d, kt).  ``rows`` defaults to d − r0, ``cols``
    to kt.

    On a CUDA device this launches ``omega_fill_f32`` or ``omega_fill_bf16``
    (``csrc/rand.cuh``, counted as ``omega_fill`` / ``omega_fill[bf16]``;
    another dtype raises :class:`TypeError`); on the CPU it is
    :func:`omega_tile` cast to ``dtype``.
    """
    rows = d - r0 if rows is None else rows
    cols = kt if cols is None else cols
    dev = resolve_device(device)
    if dev.type == "cpu":
        return omega_tile(seed, d, kt, r0=r0, rows=rows, cols=cols, device=dev).to(dtype)
    from .matmul import cuda_form  # matmul imports this module through ref

    f = cuda_form("omega_fill", dtype)
    out = torch.empty((rows, cols), dtype=dtype, device=dev)
    if rows and cols:
        build.launch(f.label, f.fn, out.data_ptr(), rows, cols, r0 & M32,
                     d, kt, seed[0] & M32, seed[1] & M32,
                     torch.cuda.current_stream(dev).cuda_stream)
    return out


def dense_omega(seed: Seed, d: int, kt: int, dtype=torch.float32,
                device=DEFAULT_DEVICE) -> torch.Tensor:
    """The full (d, kt) Ω(seed), made in f32 and rounded once to
    ``dtype``: the materialized oracle of the seeded path.  On the card it
    is one ``omega_fill`` launch in ``dtype``."""
    return omega_fill(seed, d, kt, dtype=dtype, device=device)


def prng_key(seed: int) -> Seed:
    """The raw Threefry key of an integer seed: (high, low) 32-bit words,
    as ``jax.random.PRNGKey`` makes it."""
    return (seed >> 32) & M32, seed & M32


def _split(key: Seed) -> tuple[Seed, Seed]:
    """``jax.random.split(key)`` (two keys): Threefry of counters 0, 1."""
    return tuple(threefry2x32(key[0], key[1], 0, c) for c in (0, 1))


def _bits2(key: Seed) -> Seed:
    """``jax.random.bits(key, (2,), uint32)``: both words of Threefry of
    counters 0, 1, xor-folded."""
    return tuple(x ^ y for x, y in (threefry2x32(key[0], key[1], 0, c) for c in (0, 1)))


def omega_seeds(seed: int) -> tuple[Seed, Seed]:
    """Per-view Ω seeds of an integer seed, view a first — the bits of
    ``repro.kernels.rand.seeds_from_key(jax.random.PRNGKey(seed))``."""
    ka, kb = _split(prng_key(seed))
    return _bits2(ka), _bits2(kb)
