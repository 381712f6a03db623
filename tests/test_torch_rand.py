"""The port's counter-based Ω generator against ``repro.kernels.rand``.

The uint32 stages (Threefry-2x32-20, the exponent patch, the seed
derivation) must equal the reference bitwise.  The f32 normals go
through ``log`` and ``cos``, which XLA and the port's plain version
(float64 ``log``/``cos`` rounded once to f32) round differently, so
they are held within ULP_BOUND ulp; measured on the CPU with jax 0.9 the
largest distance over 18M elements at row offsets up to 2^19 is 3 ulp.
Elements outside the logical (d, k̃) are exactly 0 on both sides, and
inside the port a tile is bitwise the matching slice of Ω wherever it
is cut.  The CUDA generator is held against the plain one by the
card-only test at the end, which skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rand as jrand
from repro_torch.kernels import rand

ULP_BOUND = 4
SEED = (0xDEADBEEF, 0x12345678)


def _ulp(x, y) -> np.ndarray:
    """Distance in f32 ulps (order-preserving integer map of the bits)."""
    def key(v):
        i = np.asarray(v, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(x) - key(y))


def _u32(seed, *shape):
    """Seeded uint32 words, the extremes 0 and 0xFFFFFFFF among them."""
    w = np.random.default_rng(seed).integers(0, 2**32, size=shape, dtype=np.uint64)
    flat = w.reshape(-1)
    flat[:4] = [0, 0xFFFFFFFF, 1, 0x80000000]
    return w.astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry2x32_is_bitwise_the_reference(seed):
    k0, k1, c0, c1 = (_u32(seed * 4 + i, 64, 33) for i in range(4))
    want = jrand.threefry2x32(*map(jnp.asarray, (k0, k1, c0, c1)))
    got = rand.threefry2x32(*(torch.from_numpy(v.astype(np.int64)) for v in (k0, k1, c0, c1)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), np.asarray(w))


def test_threefry2x32_on_python_ints_matches_tensors():
    words = [int(v) for v in _u32(7, 4)]
    got = rand.threefry2x32(*words)
    want = rand.threefry2x32(*(torch.tensor(v) for v in words))
    assert got == tuple(int(t) for t in want)


def test_f12_is_bitwise_the_reference():
    bits = _u32(3, 4096)
    want = np.asarray(jrand._f12(jnp.asarray(bits)))
    got = rand._f12(torch.from_numpy(bits.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= 1.0 and got.max() < 2.0


@pytest.mark.parametrize("s", [0, 1, 2**31 + 5])
def test_omega_seeds_are_the_reference_bits(s):
    want = jrand.seeds_from_key(jax.random.PRNGKey(s))
    got = rand.omega_seeds(s)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.array(g, np.uint32), np.asarray(w))


# (d, k̃): 128-aligned, ragged, and the one-column edge
@pytest.mark.parametrize("d,kt", [(512, 256), (300, 70), (129, 1)])
def test_dense_omega_matches_reference(d, kt):
    want = np.asarray(jrand.dense_omega(jnp.array(SEED, jnp.uint32), d, kt))
    got = rand.dense_omega(SEED, d, kt, device="cpu")
    assert got.shape == (d, kt) and got.dtype == torch.float32
    assert int(_ulp(got.numpy(), want).max()) <= ULP_BOUND
    # N(0, 1): a sanity check of the transform, not of the bits
    assert abs(float(got.mean())) < 0.1 and abs(float(got.std()) - 1.0) < 0.1


@pytest.mark.parametrize("r0,row_limit", [(0, None), (2**18 + 16, None),
                                          (2**19 - 256, 2**19 - 100), (2**19 - 128, 2**19)])
def test_normal_tile_at_offsets_matches_reference(r0, row_limit):
    """Lane-aligned tiles (the shapes the reference evaluates its
    generator on) at row offsets up to 2^19, with exact zeros past the
    row and column limits."""
    shape, col_limit = (256, 384), 300
    want = np.asarray(jrand.normal_tile(
        jnp.uint32(SEED[0]), jnp.uint32(SEED[1]), jnp.uint32(r0), jnp.uint32(0), shape,
        row_limit=row_limit, col_limit=col_limit))
    got = rand.normal_tile(SEED[0], SEED[1], r0, 0, shape, row_limit=row_limit,
                           col_limit=col_limit, device="cpu").numpy()
    assert int(_ulp(got, want).max()) <= ULP_BOUND
    outside = np.zeros(shape, bool)
    outside[:, col_limit:] = True
    if row_limit is not None:
        outside[max(0, row_limit - r0):] = True
    assert np.all(got[outside] == 0) and np.all(want[outside] == 0)
    assert np.all(got[~outside] != 0)


def test_tiles_are_bitwise_slices_of_omega():
    """Wherever a tile is cut — row offset, block of rows, padded
    columns — it is the matching slice of Ω bit for bit."""
    d, kt = 2**19, 8
    full = rand.dense_omega(SEED, d, kt, device="cpu")
    for r0, rows in [(2**18 + 16, 4096), (0, 300), (d - 77, 77)]:
        tile = rand.omega_fill(SEED, d, kt, r0=r0, rows=rows, device="cpu")
        assert torch.equal(tile, full[r0:r0 + rows])
    # past the logical edge: exact zeros (the ragged case d = 300, k̃ = 70)
    pad = rand.omega_fill(SEED, 300, 70, rows=384, cols=128, device="cpu")
    assert torch.equal(pad[:300, :70], rand.dense_omega(SEED, 300, 70, device="cpu"))
    assert bool((pad[300:] == 0).all()) and bool((pad[:, 70:] == 0).all())


@pytest.mark.parametrize("entry", [
    lambda: rand.normal_tile(SEED[0], SEED[1], 0, 0, (4, 2)),
    lambda: rand.omega_tile(SEED, 4, 2),
    lambda: rand.omega_fill(SEED, 4, 2),
    lambda: rand.dense_omega(SEED, 4, 2),
], ids=["normal_tile", "omega_tile", "omega_fill", "dense_omega"])
def test_generators_default_to_cuda_and_raise_without_it(entry):
    """Called without ``device=``, every generator asks for the card: on a
    host without CUDA it raises instead of quietly making Ω there."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def test_omega_fill_rejects_other_devices():
    with pytest.raises(ValueError, match="runs on 'cuda' or 'cpu'"):
        rand.omega_fill(SEED, 4, 2, device="meta")


# --------------------------------------------------------------------------
# the CUDA generator: card only
# --------------------------------------------------------------------------

#: The card's logf (1 ulp) and cosf (2 ulp, CUDA math API) against the
#: plain version's correctly rounded steps: ≤ 1 ulp in √(−2·log), ≤ 2 in
#: cos, one rounding of the product — at most 7 ulp of Ω at the bottom
#: of a binade.
CUDA_ULP_BOUND = 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels are CUDA C++ with "
                    "no CPU mode (chip_smoke.py runs them on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_cuda_omega_fill_matches_plain_and_slices(cuda_device):
    d, kt = 2**19, 70
    full = rand.dense_omega(SEED, d, kt, device=cuda_device)
    for r0, rows in [(0, 2048), (2**18 + 16, 4096), (d - 1000, 1000)]:
        tile = rand.omega_fill(SEED, d, kt, r0=r0, rows=rows, device=cuda_device)
        assert torch.equal(tile, full[r0:r0 + rows])
        plain = rand.omega_tile(SEED, d, kt, r0=r0, rows=rows, device="cpu")
        assert int(_ulp(tile.cpu().numpy(), plain.numpy()).max()) <= CUDA_ULP_BOUND
    pad = rand.omega_fill(SEED, 300, 70, rows=384, cols=128, device=cuda_device).cpu()
    assert bool((pad[300:] == 0).all()) and bool((pad[:, 70:] == 0).all())
    assert bool((pad[:300, :70] != 0).all())
