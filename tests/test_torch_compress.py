"""The port's collectives (``repro_torch.distributed``) against the
reference's definitions.

- ``int8_encode`` / ``int8_decode`` against ``repro.distributed.compress``
  on the same f32 inputs: BITWISE.  Both divide, round half to even and
  scale in f32, so nothing is left to differ.
- ``psum_int8_ef`` over 2 gloo ranks against the reference's definition
  (``repro/distributed/compress.py:41-76``) written out in numpy: BITWISE.
  The group's scale is a max and the payload an int32 sum, both exact,
  so the order of the ranks' sums cannot show.
- The end-of-pass Y sum of ``power_pass_local``: in column buckets
  (``bucketed_accumulate``) bitwise the one-shot sum; through int8
  (``int8_reduce``) within relative Frobenius error 0.02, the reference's
  own bound for ``psum_int8_ef`` (``tests/test_distributed.py:97``), and
  each element within one quantum of the group's scale per rank (the
  largest |Y_r| of its row over the ranks r, / 127): each rank's value is
  rounded twice, by at most half a quantum of its own scale and half of
  the group's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.compress import int8_decode as j_decode
from repro.distributed.compress import int8_encode as j_encode
from repro_torch.core import rcca_dist as td
from repro_torch.distributed import bucketed_accumulate, int8_decode, int8_encode, psum_int8_ef
from repro_torch.launch import ranks

SPAWN_TIMEOUT = 120.0  # seconds: a hung collective fails the test instead of the suite
SHAPES = [((7, 300), 256), ((3, 4, 256), 256), ((1, 1000), 64), ((4, 2060), 256)]


def _x(shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1, x.shape[-1])
    flat[0, :4] = [0.0, -0.0, 1e-40, 2.5]  # zeros, a subnormal, and a large entry
    if flat.shape[0] > 1:
        flat[1] = 0.0  # an all-zero block: its scale clamps to 1e-30
    return x


@pytest.mark.parametrize("shape,block", SHAPES)
def test_int8_encode_decode_match_reference_bitwise(shape, block):
    x = _x(shape)
    q, s = int8_encode(torch.from_numpy(x), block)
    jq, js = j_encode(jnp.asarray(x), block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    out = int8_decode(q, s, shape[-1])
    assert out.is_contiguous()  # the kernels take it as it is
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_decode(jq, js, shape[-1])))


def _np_encode(x, block):
    d = x.shape[-1]
    xb = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, (-d) % block)])
    xb = xb.reshape(*x.shape[:-1], -1, block)
    scale = np.maximum(np.abs(xb).max(-1, keepdims=True) / np.float32(127), np.float32(1e-30))
    q = np.clip(np.round(xb / scale), -127, 127).astype(np.int8)
    return q, scale[..., 0]


def _np_decode(q, scale, d):
    xb = q.astype(np.float32) * scale[..., None]
    return xb.reshape(*xb.shape[:-2], -1)[..., :d]


def _np_psum_int8_ef(xs, errs, block=256):
    """The reference's psum_int8_ef over the ranks' (x, err), in numpy."""
    xs = [x if e is None else x + e for x, e in zip(xs, errs)]
    d = xs[0].shape[-1]
    enc = [_np_encode(x, block) for x in xs]
    gscale = np.maximum.reduce([s for _, s in enc])
    q2s = []
    for q, s in enc:
        xq = _np_decode(q, s, d)
        xq = np.pad(xq, [(0, 0)] * (xq.ndim - 1) + [(0, (-d) % block)])
        q2s.append(np.clip(np.round(xq.reshape(*q.shape) / gscale[..., None]), -127, 127))
    new_errs = [x - _np_decode(q2.astype(np.int8), gscale, d) for x, q2 in zip(xs, q2s)]
    total = sum(q2.astype(np.int32) for q2 in q2s)
    return _np_decode(total, gscale, d), new_errs


@pytest.fixture(scope="module")
def two_ranks():
    """One job of 2 gloo ranks: psum_int8_ef without and with a residual,
    and power_pass_local's Y sum one-shot, in buckets and through int8."""
    x = [_x((5, 600), seed=r) for r in range(2)]
    err = [0.01 * _x((5, 600), seed=10 + r) for r in range(2)]
    mesh = ranks.OnMesh((1, 2, 1))
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal((64, 48)), rng.standard_normal((64, 40))
    qa, qb = rng.standard_normal((48, 7)), rng.standard_normal((40, 7))

    def local(r):
        rows = slice(32 * r, 32 * (r + 1))
        return tuple(torch.tensor(v, dtype=torch.float32) for v in (a[rows], b[rows], qa, qb))

    common = dict(mesh=mesh, row_axes=("data",), col_axis=None, microbatch=16,
                  compute_dtype=torch.float32)
    calls = [
        ranks.Call(td._psum_int8, [(torch.from_numpy(x[r]), mesh, ("data",), None)
                                   for r in range(2)]),
        ranks.Call(td._psum_int8, [(torch.from_numpy(x[r]), mesh, ("data",),
                                    torch.from_numpy(err[r])) for r in range(2)]),
        ranks.Call(td.power_pass_local, [local(r) for r in range(2)], common),
        ranks.Call(td.power_pass_local, [local(r) for r in range(2)],
                   dict(common, reduce_buckets=3)),
        ranks.Call(td.power_pass_local, [local(r) for r in range(2)],
                   dict(common, int8_reduce=True)),
    ]
    out = ranks.run(calls, 2, timeout=SPAWN_TIMEOUT)
    return x, err, out, (a, b, qa, qb)


@pytest.mark.parametrize("with_err", [False, True], ids=["no-residual", "residual"])
def test_psum_int8_ef_two_ranks_matches_numpy_definition(two_ranks, with_err):
    x, err, out, _ = two_ranks
    got = out[1 if with_err else 0]
    want, want_err = _np_psum_int8_ef(x, err if with_err else [None, None])
    for r in range(2):
        total, new_err = got[r]
        np.testing.assert_array_equal(total, want)  # every rank holds the same sum
        np.testing.assert_array_equal(new_err, want_err[r])
    exact = x[0] + x[1] + ((err[0] + err[1]) if with_err else 0)
    assert np.linalg.norm(want - exact) / np.linalg.norm(exact) < 0.02


def test_power_pass_row_sum_in_buckets_is_the_one_shot_sum(two_ranks):
    *_, out, (a, b, qa, qb) = two_ranks
    one, buck = out[2], out[3]
    for r in range(2):
        for u, v in zip(one[r], buck[r]):
            np.testing.assert_array_equal(u, v)
    Ya = one[0][0]
    want = a.T @ (b @ qb)
    assert np.abs(Ya - want).max() <= 1e-5 * np.abs(want).max()


def test_power_pass_int8_row_sum_within_tolerance(two_ranks):
    *_, out, (a, b, qa, qb) = two_ranks
    one, i8 = out[2], out[4]
    halves = [slice(0, 32), slice(32, 64)]
    # each rank's own (da, k̃) and (db, k̃) contributions; one int8 block per row
    local = [[a[h].T @ (b[h] @ qb) for h in halves], [b[h].T @ (a[h] @ qa) for h in halves]]
    for r in range(2):
        for y8, y, parts in zip(i8[r][:2], one[r][:2], local):
            assert np.linalg.norm(y8 - y) / np.linalg.norm(y) < 0.02
            quantum = np.maximum(*(np.abs(p).max(axis=1, keepdims=True) for p in parts)) / 127
            assert (np.abs(y8 - y) <= 2 * quantum * (1 + 1e-5)).all()
        for u, v in zip(one[r][2:], i8[r][2:]):  # the row statistics are exact sums
            np.testing.assert_array_equal(u, v)


def test_psum_int8_ef_alone_is_requantization():
    """A group of one rank issues no collective: the result is x + err
    quantized against its own scales."""
    x, e = _x((3, 500), seed=1), 0.01 * _x((3, 500), seed=2)
    got, new_err = psum_int8_ef(torch.from_numpy(x), None, torch.from_numpy(e))
    want, want_err = _np_psum_int8_ef([x], [e])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(new_err.numpy(), want_err[0])


def test_bucketed_accumulate_alone_splits_and_joins():
    parts = [torch.randn(6, 10, generator=torch.Generator().manual_seed(i)) for i in range(3)]
    got = bucketed_accumulate(parts, None, n_buckets=4)
    assert torch.equal(got, parts[0] + parts[1] + parts[2])
    assert torch.equal(bucketed_accumulate(parts[0], None, n_buckets=64), parts[0])
