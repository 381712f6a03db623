"""Package-level rules of the PyTorch port: isolation from the JAX
package, device resolution, the canonical accumulation order, the
configuration copy, and the stream-mode launcher on the CPU."""

import re
import weakref
from pathlib import Path
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import europarl_cca as jconf
from repro.exec import accumulate as jacc
from repro.exec import engine as jengine
from repro_torch.configs import europarl_cca as tconf
from repro_torch.core import rcca as tr
from repro_torch.data import DevicePlantedChunks
from repro_torch.exec import FitState, PassEngine, delta_refit, fit_with_state
from repro_torch.exec import accumulate as tacc, engine as tengine
from repro_torch.launch import cca_fit, cca_serve
from repro_torch.serve import ModelRegistry

ROOT = Path(__file__).resolve().parents[1]

# `import jax`, `from jax...`, `import repro`, `from repro...` — the word
# boundary keeps `repro_torch` from matching
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)\b(?!_)", re.MULTILINE)


def _port_files():
    return (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("*_torch.py"))
            + sorted((ROOT / "scripts").glob("*.py")))


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) > 10
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert hits == []


def test_isolation_pattern_catches_what_it_should():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("    from repro.core import rcca")
    assert FORBIDDEN.search("import repro")
    assert not FORBIDDEN.search("from repro_torch.core import rcca")
    assert not FORBIDDEN.search("import jaxlib_free_module")


# --------------------------------------------------------------------------
# device: entry points default to CUDA and raise without it
# --------------------------------------------------------------------------


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    cfg = tr.RCCAConfig(k=2, p=2, q=0)
    A = np.zeros((8, 5), np.float32)
    Q = np.zeros((5, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.randomized_cca(A, A, cfg, Q, Q)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.randomized_cca_streaming(A[None], A[None], cfg, Q, Q)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.draw_omega(0, 5, 5, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PassEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.init_power_stats(5, 5, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.init_final_stats(4, 5, 5)
    for kind in ("power", "final"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tr.stats_init_fn(kind, 5, 5, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cca_fit.main(["--smoke"])
    # the incremental fit and the serving tier
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit_with_state(str(tmp_path / "store"), cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        delta_refit(FitState(meta={}, passes={}), str(tmp_path / "store"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRegistry(str(tmp_path / "registry")).load("m")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cca_serve.main(["--smoke", "--store", str(tmp_path / "store"),
                        "--registry", str(tmp_path / "registry")])
    assert not (tmp_path / "store").exists()


# --------------------------------------------------------------------------
# accumulation order: bitwise the reference's on the same f32 numbers
# --------------------------------------------------------------------------


class One(NamedTuple):
    v: object


@pytest.mark.parametrize("n_chunks,group", [(1, 8), (8, 8), (9, 8), (20, 8), (13, 3), (16, 1)])
def test_segmented_accumulation_order_matches_reference(n_chunks, group):
    """Values spread over many magnitudes make f32 sums order-sensitive:
    equal bits mean equal reduction trees."""
    rng = np.random.default_rng(n_chunks * 31 + group)
    vals = (rng.standard_normal((n_chunks, 6)) * 10.0 ** rng.integers(-6, 6, (n_chunks, 6))
            ).astype(np.float32)

    def fold(mod, zeros, to):
        acc = mod.SegmentedAccumulator(lambda: One(zeros()), n_chunks, group)
        for i in range(n_chunks):
            acc.update(i, lambda s, a, *_: One(s.v + a), to(vals[i]), None, None, None)
        return np.asarray(acc.result().v)

    got = fold(tacc, lambda: torch.zeros(6), torch.from_numpy)
    want = fold(jacc, lambda: jnp.zeros(6, jnp.float32), jnp.asarray)
    np.testing.assert_array_equal(got, want)


def test_unknown_length_stream_closes_its_tail():
    acc = tacc.SegmentedAccumulator(lambda: One(torch.zeros(())), None, 4)
    for i in range(6):
        acc.update(i, lambda s, a, *_: One(s.v + a), torch.tensor(1.0), None, None, None)
    assert acc.groups_done == 1
    tengine.run_fold(iter(()), None, acc, None, None)
    assert acc.groups_done == 2 and float(acc.result().v) == 6.0


def test_fold_releases_each_chunk_before_the_next():
    """At Europarl width a chunk pair is 34 GB: the engine must drop
    chunk i before its source makes chunk i+1."""
    made = []
    g = torch.Generator()
    g.manual_seed(0)

    def make():
        a, b = torch.randn((16, 5), generator=g), torch.randn((16, 4), generator=g)
        made.append((weakref.ref(a), weakref.ref(b)))
        return a, b

    def source():
        for _ in range(5):
            assert all(r() is None for pair in made for r in pair), "a chunk outlived its fold"
            yield make()

    for engine in ("kernels", "torch"):
        made.clear()
        cfg = tr.RCCAConfig(k=1, p=2, q=1)
        PassEngine(cfg, engine=engine, device="cpu").run_stream(
            source, 5, 4, torch.randn((5, 3), generator=g), torch.randn((4, 3), generator=g),
            n_chunks=5)
        assert len(made) == 10  # two passes of five chunks


def test_pass_schedule_matches_reference():
    for q in range(4):
        assert list(tengine.pass_schedule(q)) == list(jengine.pass_schedule(q))


def test_workload_config_copy_matches_reference():
    for mine, theirs in ((tconf.config(), jconf.config()),
                         (tconf.smoke_config(), jconf.smoke_config())):
        assert (mine.name, mine.n, mine.da, mine.db, mine.chunk) == \
            (theirs.name, theirs.n, theirs.da, theirs.db, theirs.chunk)
        for f in ("k", "p", "q", "lam_a", "lam_b", "nu", "center"):
            assert getattr(mine.rcca, f) == getattr(theirs.rcca, f), f
        assert mine.rcca.sketch == theirs.rcca.sketch


# --------------------------------------------------------------------------
# data made on the device, and the launcher
# --------------------------------------------------------------------------


def test_device_planted_chunks_replay_and_shape():
    src = DevicePlantedChunks(1000, 40, 30, rank=6, seed=2, chunk=300, device="cpu")
    assert src.n_chunks == 4
    chunks = list(src)
    assert [a.shape for a, _ in chunks] == [(300, 40)] * 3 + [(100, 40)]
    again = src.get_chunk(1)
    assert torch.equal(again[0], chunks[1][0]) and torch.equal(again[1], chunks[1][1])
    assert not torch.equal(chunks[0][0][:100], chunks[3][0])
    a, b = src.materialize()
    # the planted signal: the two views' top canonical correlation is high
    a, b = a - a.mean(0), b - b.mean(0)
    qa, _ = torch.linalg.qr(a.double())
    qb, _ = torch.linalg.qr(b.double())
    assert float(torch.linalg.svdvals(qa.T @ qb)[0]) > 0.9


@pytest.mark.parametrize("engine", ["kernels", "torch"])
def test_launcher_smoke_on_cpu(engine, capsys):
    rep = cca_fit.main(["--smoke", "--device", "cpu", "--engine", engine])
    out = capsys.readouterr().out
    assert "sum rho" in out and "exact-oracle objective gap" in out
    rho = rep.result.rho
    assert rho.shape == (8,) and bool(torch.isfinite(rho).all())
    assert bool((rho[:-1] >= rho[1:]).all()) and float(rho[0]) <= 1.0
    assert len(rep.pass_seconds) == 2 and rep.pass_launches == [{}, {}]
    ev = cca_fit.evaluate(rep, tconf.smoke_config(), device="cpu")
    assert max(ev["feasibility"].values()) <= 1e-4
    assert 0.0 <= ev["gap"] <= 0.05


def test_launcher_engines_agree_and_n_chunks_cuts():
    wl = tconf.smoke_config()
    k = cca_fit.fit(wl, engine="kernels", device="cpu", n_chunks=3)
    t = cca_fit.fit(wl, engine="torch", device="cpu", n_chunks=3)
    assert k.n == 3 * wl.chunk and k.n_chunks == 3
    assert float((k.result.rho - t.result.rho).abs().max()) <= 1e-5
