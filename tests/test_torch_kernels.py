"""The port's kernel entry points against the JAX reference's Pallas kernels.

On the CPU each wrapper of ``repro_torch.kernels`` takes its plain
PyTorch version; the reference runs its Pallas kernels in interpret
mode, as its own tests do.  Same numpy inputs (seeded) through both;
tolerance f32 relative Frobenius ≤ 1e-5 (the two sides sum in
different orders; f32 rounding over these K ≤ 4096 terms stays near
1e-7).  The CUDA kernels themselves are held against the same plain
versions by the card-only test at the end, which skips here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.matmul import pallas_matmul
from repro.kernels.powerpass import powerpass_sweep as j_powerpass_sweep
from repro.kernels.powerpass import proj_stage as j_proj_stage
from repro.kernels.projgram import gram_sweep as j_gram_sweep
from repro_torch import kernels as tk
from repro_torch.kernels import build, ref

RTOL = 1e-5

# ragged small shapes (n, d, k̃), and one with a multi-block sweep
SHAPES = [(130, 300, 67), (77, 129, 1), (256, 4096, 512)]


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("n,d,kt", SHAPES)
def test_proj_stage_matches_reference(n, d, kt):
    x, q = _randn(0, n, d), _randn(1, d, kt)
    want = j_proj_stage(jnp.asarray(x), jnp.asarray(q), interpret=True)
    assert _rel(tk.proj_stage(_t(x), _t(q)), want) <= RTOL


@pytest.mark.parametrize("n,d,kt", SHAPES)
def test_powerpass_sweep_matches_reference(n, d, kt):
    a, p = _randn(2, n, d), _randn(3, n, kt)
    want = j_powerpass_sweep(jnp.asarray(a), jnp.asarray(p), interpret=True)
    assert _rel(tk.powerpass_sweep(_t(a), _t(p)), want) <= RTOL


@pytest.mark.parametrize("n,d,kt", SHAPES)
def test_powerpass_sweep_out_accumulates(n, d, kt):
    """``out=`` adds the full contraction into the accumulator: the same
    bits as ``out + ΔY``."""
    a, p, y0 = _randn(4, n, d), _randn(5, n, kt), _randn(6, d, kt)
    out = _t(y0.copy())
    got = tk.powerpass_sweep(_t(a), _t(p), out=out)
    assert got is out
    assert torch.equal(got, _t(y0) + tk.powerpass_sweep(_t(a), _t(p)))


@pytest.mark.parametrize("n,kt", [(130, 67), (256, 1100), (5, 3)])
def test_gram_sweep_matches_reference(n, kt):
    p = _randn(7, n, kt)
    want = j_gram_sweep(jnp.asarray(p), interpret=True)
    assert _rel(tk.gram_sweep(_t(p)), want) <= RTOL


@pytest.mark.parametrize("n,m,kt", [(130, 67, 67), (256, 300, 129), (3, 1, 2)])
def test_matmul_tn_matches_reference(n, m, kt):
    x, y = _randn(8, n, m), _randn(9, n, kt)
    want = pallas_matmul(jnp.asarray(x), jnp.asarray(y), transpose_lhs=True, interpret=True)
    assert _rel(tk.matmul_tn(_t(x), _t(y)), want) <= RTOL


# --------------------------------------------------------------------------
# per-chunk updates against repro.kernels.ops under the staged schedule
# --------------------------------------------------------------------------

# (n, da, db, k̃): the second has a 2-bucket ΔYa sweep (da·k̃p past the
# reference's VMEM row cap), the third ragged everywhere
POWER_SHAPES = [(130, 96, 200, 67), (256, 4096, 256, 512), (77, 129, 61, 33)]


@pytest.mark.parametrize("n,da,db,kt", POWER_SHAPES)
def test_power_pass_chunk_matches_reference_staged(n, da, db, kt):
    a, b = _randn(10, n, da), _randn(11, n, db)
    Qa, Qb = _randn(12, da, kt), _randn(13, db, kt)
    want = jops.power_pass_chunk(*map(jnp.asarray, (a, b, Qa, Qb)),
                                 schedule="staged", interpret=True)
    got = tk.power_pass_chunk(*map(_t, (a, b, Qa, Qb)))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= RTOL


def test_power_pass_chunk_out_is_in_place():
    a, b = _randn(14, 64, 40), _randn(15, 64, 30)
    Qa, Qb = _randn(16, 40, 9), _randn(17, 30, 9)
    Ya, Yb = torch.ones(40, 9), torch.ones(30, 9)
    dYa, dYb = tk.power_pass_chunk(*map(_t, (a, b, Qa, Qb)))
    got = tk.power_pass_chunk(*map(_t, (a, b, Qa, Qb)), out=(Ya, Yb))
    assert got[0] is Ya and got[1] is Yb
    assert torch.equal(Ya, 1 + dYa) and torch.equal(Yb, 1 + dYb)


# (n, da, db, k̃): k̃ = 1100 buckets the reference's C columns (9 buckets)
FINAL_SHAPES = [(130, 96, 200, 67), (130, 96, 200, 1100), (77, 129, 61, 33)]


@pytest.mark.parametrize("n,da,db,kt", FINAL_SHAPES)
def test_final_pass_chunk_matches_reference_staged(n, da, db, kt):
    a, b = _randn(18, n, da), _randn(19, n, db)
    Qa, Qb = _randn(20, da, kt), _randn(21, db, kt)
    want = jops.final_pass_chunk(*map(jnp.asarray, (a, b, Qa, Qb)),
                                 schedule="staged", interpret=True)
    got = tk.final_pass_chunk(*map(_t, (a, b, Qa, Qb)))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= RTOL


@pytest.mark.parametrize("kind", ["power", "final"])
def test_chunk_refs_match_reference_refs(kind):
    a, b = _randn(22, 50, 31), _randn(23, 50, 17)
    Qa, Qb = _randn(24, 31, 12), _randn(25, 17, 12)
    port = ref.power_pass_ref if kind == "power" else ref.final_pass_ref
    jax_ref = jref.power_pass_ref if kind == "power" else jref.final_pass_ref
    for g, w in zip(port(*map(_t, (a, b, Qa, Qb))), jax_ref(*map(jnp.asarray, (a, b, Qa, Qb)))):
        assert _rel(g, w) <= RTOL


def test_chunk_updates_match_refs_and_launch_nothing_on_cpu():
    """On the CPU the per-chunk updates are the plain versions — the
    same values as ``ref`` — and no kernel launch is counted."""
    a, b = _t(_randn(26, 40, 23)), _t(_randn(27, 40, 19))
    Qa, Qb = _t(_randn(28, 23, 7)), _t(_randn(29, 19, 7))
    tk.reset_launch_counts()
    for g, w in zip(tk.power_pass_chunk(a, b, Qa, Qb), ref.power_pass_ref(a, b, Qa, Qb)):
        assert torch.equal(g, w)
    for g, w in zip(tk.final_pass_chunk(a, b, Qa, Qb), ref.final_pass_ref(a, b, Qa, Qb)):
        assert torch.equal(g, w)
    assert tk.launch_counts() == {}


def test_wrappers_reject_unsupported_devices():
    x = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.proj_stage(x, torch.empty(3, 2, device="meta"))


def test_build_targets_are_keyed_by_source_and_flags(tmp_path, monkeypatch):
    assert set(build.LIBRARIES) == {"gemm_f32", "gemm_bf16", "recompute_f32", "gemm_rows"}
    for name in build.LIBRARIES:
        target = build._target(name)
        assert target.parent == build.BUILD_DIR
        assert target.name.startswith(f"{name}-") and target.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    # every header under csrc/ is in every digest, so an edited one rebuilds
    assert sorted(build.HEADERS) == sorted(build.CSRC.glob("*.cuh"))
    copies = {}
    for f in build.CSRC.iterdir():
        copies[f] = tmp_path / f.name
        copies[f].write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "LIBRARIES", {k: copies[v] for k, v in build.LIBRARIES.items()})
    monkeypatch.setattr(build, "HEADERS", tuple(copies[h] for h in build.HEADERS))
    before = {name: build._target(name) for name in build.LIBRARIES}
    for header in build.HEADERS:
        header.write_bytes(header.read_bytes() + b"\n")
        after = {name: build._target(name) for name in build.LIBRARIES}
        assert all(after[name] != before[name] for name in build.LIBRARIES), header.name
        before = after


# --------------------------------------------------------------------------
# the CUDA kernels themselves: card only
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels are CUDA C++ with "
                    "no CPU mode (chip_smoke.py runs them on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,d,kt", [(1000, 1000, 100), (333, 517, 67), (8192, 4096, 2060)])
def test_cuda_kernels_match_plain_and_repeat(cuda_device, n, d, kt):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    x = torch.randn((n, d), generator=g, device=cuda_device)
    q = torch.randn((d, kt), generator=g, device=cuda_device)
    tk.reset_launch_counts()
    p = tk.proj_stage(x, q)
    pairs = [(p, ref.proj_stage_ref(x, q), d),
             (tk.powerpass_sweep(x, p), ref.powerpass_sweep_ref(x, p), n),
             (tk.gram_sweep(p), ref.gram_sweep_ref(p), n),
             (tk.matmul_tn(p, p), ref.matmul_tn_ref(p, p), n)]
    for got, want, K in pairs:
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 4 * K ** 0.5 * 2.0 ** -24
    assert torch.equal(tk.proj_stage(x, q), p)
    assert tk.launch_counts() == {"proj_stage": 2, "powerpass_sweep": 1,
                                  "gram_sweep": 1, "matmul_tn": 1}
