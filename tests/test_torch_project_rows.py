"""The serving form of ``_mm_nn_kernel``: ``kernels.project_rows``
(``csrc/gemm_rows.cu``, CUDA only) and its plain version.

- The plain version (``ref.project_rows_ref``) against numpy in f64
  within 4·√K·u of the largest magnitude — the statistical growth of f32
  rounding over a K-term sum — and against the reference's serving
  projection (``repro/serve/projector.py`` ``x @ X``, jitted by XLA) within
  REF_RTOL on the same numpy inputs.
- The reduction's shape is a function of K alone: segments of
  ``plan.ROWS_KSEG`` rows, the partials padded with zeros to a power of two
  and added pairwise level by level — checked bitwise on partials whose
  association shows in the bits, at K below one segment, at one segment,
  at a K that is not a multiple of it and at odd segment counts.
- The launch plan (FLOPs, bytes, tiles, slices), the kernel source's
  constants and C signature, the ``FORMS`` row and its label, and the
  refusals; the serving projection of the kernels engine is this form.
- On the card only (skipped here, visibly): a 512-row launch's rows are
  bitwise a 32-row launch's and each row's alone.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.projector import _project_jit
from repro_torch.kernels import build, matmul, plan, project_rows, ref
from repro_torch.serve import projector as tprojector

U = 2.0 ** -24
KSEG = plan.ROWS_KSEG
# the port against the reference on the same rows: two f32 products from two
# libraries (torch, XLA), whose sums are ordered differently
REF_RTOL = 1e-5
SOURCE = (build.CSRC / "gemm_rows.cu").read_text()


def _inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            (rng.standard_normal((K, N)) / 30).astype(np.float32))


def _padded_tree(v: np.ndarray) -> np.float32:
    """The contract's tree, written recursively over the padded slots."""
    P = 1 << (len(v) - 1).bit_length()
    slots = list(v.astype(np.float32)) + [np.float32(0)] * (P - len(v))

    def node(lo, hi):
        if hi - lo == 1:
            return slots[lo]
        mid = (lo + hi) // 2
        return np.float32(node(lo, mid) + node(mid, hi))
    return node(0, P)


SHAPES = [(5, KSEG // 2 + 3, 60), (7, KSEG, 60), (3, 3 * KSEG + 5, 67), (9, 5 * KSEG, 4),
          (1, 7 * KSEG - 1, 60)]


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plain_matches_float64(M, K, N):
    x, X = _inputs(M, K, N)
    got = ref.project_rows_ref(torch.from_numpy(x), torch.from_numpy(X)).numpy()
    want = x.astype(np.float64) @ X.astype(np.float64)
    assert got.dtype == np.float32 and got.shape == (M, N)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 4 * math.sqrt(K) * U * scale


@pytest.mark.parametrize("M,K,N", [(32, 3 * KSEG + 5, 60), (1, 2 * KSEG, 60)])
def test_plain_matches_the_reference_projection(M, K, N):
    x, X = _inputs(M, K, N, seed=1)
    want = np.asarray(_project_jit(K, N, M)(jnp.asarray(X), jnp.asarray(x)))
    got = ref.project_rows_ref(torch.from_numpy(x), torch.from_numpy(X)).numpy()
    assert np.abs(got - want).max() <= REF_RTOL * np.abs(want).max()


@pytest.mark.parametrize("K", [KSEG // 2 + 3, KSEG, 3 * KSEG + 5, 5 * KSEG, 7 * KSEG - 1])
def test_tree_shape_is_a_function_of_k(K):
    """One nonzero term at the head of each segment, so each segment's
    partial is that term exactly, whatever order sums its zeros; the
    terms' magnitudes make every association give other bits.  The plain
    version must give the padded tree of the S = ⌈K / KSEG⌉ partials."""
    S = plan.rows_segments(K)
    assert S == -(-K // KSEG)
    rng = np.random.default_rng(K)
    heads = (rng.standard_normal(S) * 10.0 ** rng.integers(-6, 7, S)).astype(np.float32)
    X = np.zeros((K, 1), np.float32)
    X[np.arange(S) * KSEG, 0] = heads
    x = np.ones((1, K), np.float32)
    got = ref.project_rows_ref(torch.from_numpy(x), torch.from_numpy(X)).numpy()[0, 0]
    assert got == _padded_tree(heads)
    # the tree over stacked partials, and its shape by S alone
    parts = (rng.standard_normal((S, 3, 2)) * 10.0 ** rng.integers(-4, 5, (S, 1, 1))).astype(
        np.float32)
    tree = ref.segment_tree(torch.from_numpy(parts)).numpy()
    for i, j in np.ndindex(3, 2):
        assert tree[i, j] == _padded_tree(parts[:, i, j])


def test_tree_differs_from_one_chain():
    """The test above has power: a left-to-right sum of the same partials
    gives other bits for one of them."""
    rng = np.random.default_rng(0)
    v = (rng.standard_normal(7) * 10.0 ** rng.integers(-6, 7, 7)).astype(np.float32)
    chain = np.float32(0)
    for t in v:
        chain = np.float32(chain + t)
    assert chain != _padded_tree(v)


@pytest.mark.parametrize("M,K,N,slices", [(1, 2 ** 19, 60, 1), (32, 2 ** 19, 60, 1),
                                          (512, 2 ** 19, 60, 1), (8192, 2 ** 19, 60, 8),
                                          (333, 9001, 67, 1)])
def test_plan_counts_the_products_the_tree_and_the_partials(M, K, N, slices):
    S = plan.rows_segments(K)
    launches = plan.plan_project_rows(M, K, N)
    assert [p.kernel for p in launches] == ["gemm_rows_segment", "gemm_rows_tree"] * slices
    flops, nbytes = plan.cost(launches)
    assert flops == 2 * M * K * N + M * N * (S - 1)
    assert nbytes == 4 * (M * K + slices * K * N + M * N) + 2 * 4 * S * M * N
    assert not any(p.tc_flops for p in launches)
    tile = plan.rows_tile(M)
    bm, bn, threads, _ = plan.ROWS_TILES[tile]
    assert bm == (16 if M <= 16 else 64)
    rows = plan.rows_slice(M, K, N)
    seg = launches[0]
    assert seg.grid == (-(-min(rows, M) // bm), S, -(-N // bn)) and seg.block == (threads,)
    assert seg.smem_bytes == plan.rows_smem(tile)
    # the scratch of partials stays under its cap, in whole tiles of either shape
    assert 4 * S * rows * N <= plan.ROWS_SCRATCH_BYTES or rows == 64
    assert rows == M or rows % 64 == 0


def test_constants_match_the_kernel_source():
    """``plan``'s segment, tiles, ring and tree block are ``gemm_rows.cu``'s."""
    c = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", SOURCE)}
    assert c["KSEG"] == plan.ROWS_KSEG and plan.ROWS_KSEG & (plan.ROWS_KSEG - 1) == 0
    assert c["BN"] == 64 and c["THREADS"] == 256 and c["TREE_THREADS"] == plan.ROWS_TREE_THREADS
    assert c["STAGES"] == 4 and "constexpr int BK = gemm_ring::BK;" in SOURCE
    tiles = [tuple(map(int, m)) for m in
             re.findall(r"using Tile\d = Tile<(\d+), (\d+)>;", SOURCE)]
    assert [(16 * tm, c["BN"], c["THREADS"], per_sm) for tm, per_sm in tiles] == list(
        plan.ROWS_TILES)
    for tile, (bm, bn, _, per_sm) in enumerate(plan.ROWS_TILES):
        smem = plan.rows_smem(tile)
        assert smem == c["STAGES"] * plan.RING_BK * (bm + bn) * 4
        assert per_sm * (smem + plan.SMEM_RESERVED) <= plan.SMEM_PER_SM


def test_c_signature_matches_the_binding():
    """``gemm_rows_f32``'s C parameters, in order, are the ones
    ``build.SIGNATURES`` binds and the wrapper passes."""
    block = SOURCE.split('extern "C" {', 1)[1]
    params = re.search(r"int gemm_rows_f32\(([^)]*)\)", block).group(1)
    names = [p.rsplit(" ", 1)[1].lstrip("*") for p in " ".join(params.split()).split(", ")]
    assert names == ["x", "X", "out", "part", "M", "N", "K", "slice_rows", "tile", "vec",
                     "stream"]
    P, I64, INT = build._ptr, build._i64, build._int
    assert build.SIGNATURES["gemm_rows"]["gemm_rows_f32"] == [P, P, P, P, I64, I64, I64, I64,
                                                              INT, INT, P]
    assert build.LIBRARIES["gemm_rows"].name == "gemm_rows.cu"
    assert build.ERROR_STRINGS["gemm_rows"] == "gemm_rows_error_string"


def test_wrapper_passes_the_bound_arguments(monkeypatch):
    """The launcher's call, captured: one argument per bound C parameter,
    the sizes and the slice of rows, the tile ``plan.rows_tile`` picks
    from M and 16-byte copies for aligned rows."""
    calls = []
    monkeypatch.setattr(build, "launch", lambda entry, fn, *args: calls.append((entry, fn, args)))
    monkeypatch.setattr(matmul, "_stream", lambda t: 0)
    x, X = torch.zeros(40, 3 * KSEG), torch.zeros(3 * KSEG, 60)
    f = matmul.form("project_rows", x, X)
    out = matmul.gemm_rows(f, x, X)
    matmul.gemm_rows(f, x[:3].contiguous(), X)
    assert out.shape == (40, 60)
    (entry, fn, args), small = calls
    assert (entry, fn) == ("project_rows", "gemm_rows_f32")
    assert len(args) == len(build.SIGNATURES["gemm_rows"][fn])
    assert args[4:8] == (40, 60, 3 * KSEG, 40) and args[8:10] == (1, 3)
    assert small[2][4] == 3 and small[2][8] == 0


def test_form_row_and_label():
    assert matmul.FORMS["project_rows"] == {(torch.float32, torch.float32): "gemm_rows_f32"}
    f = matmul.cuda_form("project_rows", torch.float32, torch.float32)
    assert f == matmul.Form("gemm_rows_f32", "project_rows")
    with pytest.raises(TypeError, match="project_rows"):
        matmul.cuda_form("project_rows", torch.bfloat16, torch.bfloat16)
    assert "gemm_rows_f32" not in matmul.RING | matmul.WGMMA | matmul.FUSED


def test_refusals():
    x, X = torch.zeros(4, 6), torch.zeros(6, 3)
    with pytest.raises(ValueError, match="different devices"):
        project_rows(x, X.to("meta"))
    with pytest.raises(ValueError, match="contraction mismatch"):
        project_rows(x, torch.zeros(5, 3))
    with pytest.raises(ValueError, match="empty contraction"):
        project_rows(torch.zeros(4, 0), torch.zeros(0, 3))


def test_serving_projection_is_this_form():
    """The kernels engine's projection is ``project_rows`` (on the CPU its
    plain version, bitwise), for a block of rows and for one row (whose
    plain product is the row's own: the CPU's need not be batch
    invariant)."""
    x, X = _inputs(6, 2 * KSEG + 9, 5, seed=3)
    X_t = torch.from_numpy(X)
    want = ref.project_rows_ref(torch.from_numpy(x), X_t)
    assert torch.equal(tprojector.project(X_t, x, "kernels"), want)
    assert torch.equal(tprojector.project(X_t, x[2], "kernels"),
                       ref.project_rows_ref(torch.from_numpy(x[2:3]), X_t)[0])
    assert torch.equal(project_rows(torch.from_numpy(x), X_t), want)
    assert build.LAUNCHES["project_rows"] == 0  # plain versions launch nothing


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: gemm_rows.cu has no CPU mode "
                    "(chip_smoke.py runs it on the card)")
    return torch.device("cuda")


def test_rows_are_batch_invariant_on_the_card(cuda_device):
    """The contract on the card: a row's output has the same bits in a
    launch of 512, 32 or 1 rows (both segment tiles are taken)."""
    x, X = (torch.from_numpy(t).to(cuda_device) for t in _inputs(512, 2 ** 16, 60))
    out = project_rows(x, X)
    assert torch.equal(project_rows(x[:32].contiguous(), X), out[:32])
    for i in (0, 1, 255, 511):
        assert torch.equal(project_rows(x[i:i + 1], X)[0], out[i])
    want = ref.project_rows_ref(x, X)
    assert (out - want).abs().max() <= 4 * math.sqrt(2 ** 16) * U * want.abs().max()
