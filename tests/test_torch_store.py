"""The port's view store (``repro_torch.store``) and its store-backed fit.

Counterparts of the reference's ``tests/test_store.py`` (round trips,
random access, sharding, integrity, prefetching, URI dispatch, the
pipeline heuristic), then what only the port has to show:

- the on-disk format is the reference's, byte for byte, both ways, in
  f32 and in bf16 (the reference writes bf16 through ``ml_dtypes``, the
  port through torch, and the port reads it without ``ml_dtypes``);
- the store-backed fit is bitwise the in-memory ``PassEngine.run`` of
  the same rows and Ω (both engines, materialized and seeded Ω), and
  within 1e-4 in ρ of the reference's store-backed fit on the same store
  and Ω (f32 sums in another order, as in ``test_torch_rcca.py``);
- ``cca_fit --data`` ingests, fits and refuses a store the disk cannot
  hold.
"""

import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rcca as jr
from repro.data.synthetic import PlantedCCAData as JPlanted
from repro.store import PassRunner as JPassRunner
from repro.store import ViewStoreReader as JReader
from repro.store import ingest_chunks as j_ingest_chunks
from repro_torch.core import rcca as tr
from repro_torch.data import PlantedCCAData
from repro_torch.exec import PassEngine, StackedChunks
from repro_torch.store import (
    ChunkPrefetcher,
    PassRunner,
    StoreFS,
    ViewStoreReader,
    ViewStoreWriter,
    choose_pipeline,
    extend_chunks,
    ingest_chunks,
    ingest_planted,
    prefetched,
    register_scheme,
    shard_chunks,
    store_exists,
)

ROOT = Path(__file__).resolve().parents[1]


def f32(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def corpus():
    # chunk 200 against 500 rows a shard: chunks straddle shard boundaries
    return PlantedCCAData(n=2000, da=40, db=32, rank=6, noise=0.4, seed=3, chunk=200)


@pytest.fixture(scope="module")
def store(corpus, tmp_path_factory):
    return ingest_planted(str(tmp_path_factory.mktemp("views") / "store"), corpus,
                          rows_per_shard=500)


def test_manifest_geometry(store, corpus):
    assert (store.n, store.da, store.db) == (2000, 40, 32)
    assert store.chunk == corpus.chunk and store.n_chunks == corpus.n_chunks
    assert len(store.shards) == 4
    assert store.dtype == "float32" and store.torch_dtype == torch.float32
    assert store.nbytes == 2000 * (40 + 32) * 4
    assert store.fingerprint() == ViewStoreReader(store.path).fingerprint()
    assert store_exists(store.path)


def test_chunk_round_trip(store, corpus):
    """Every chunk comes back as f32 CPU tensors, bit-equal to the rows
    ingested (the numpy generator's float64 rounded to f32)."""
    for i in range(store.n_chunks):
        a0, b0 = corpus.get_chunk(i)
        a1, b1 = store.get_chunk(i)
        assert a1.dtype == torch.float32 and a1.device.type == "cpu"
        np.testing.assert_array_equal(f32(a0), a1.numpy())
        np.testing.assert_array_equal(f32(b0), b1.numpy())


def test_random_access_spans_shards(store, corpus):
    """Chunk 2 covers rows [400, 600): across the shard 0/1 boundary."""
    a, b = store.get_chunk(2)
    np.testing.assert_array_equal(a.numpy(), f32(corpus.get_chunk(2)[0]))
    assert tuple(a.shape) == (200, 40) and tuple(b.shape) == (200, 32)
    with pytest.raises(IndexError):
        store.get_chunk(store.n_chunks)


def test_iter_chunks_seek(store):
    tail = list(store.iter_chunks(start=7))
    assert len(tail) == store.n_chunks - 7
    assert torch.equal(tail[0][0], store.get_chunk(7)[0])
    raw = list(store.iter_raw(7))
    assert len(raw) == len(tail) and np.array_equal(raw[0][0], tail[0][0].numpy())


def test_row_shard_partitions_corpus(store):
    n_shards = 3
    seen = []
    for w in range(n_shards):
        got = list(store.row_shard(w, n_shards))
        assert len(got) == len(range(w, store.n_chunks, n_shards))
        seen += [w + i * n_shards for i in range(len(got))]
        for i, (a, _) in enumerate(got):
            assert torch.equal(a, store.get_chunk(w + i * n_shards)[0])
    assert sorted(seen) == list(range(store.n_chunks))


def test_row_shard_start_and_group(store):
    want = [i for i in range(1, store.n_chunks, 3) if i >= 5]
    got = list(store.row_shard(1, 3, start=5))
    assert len(got) == len(want)
    for i, (a, _) in zip(want, got):
        assert torch.equal(a, store.get_chunk(i)[0])
    n_shards, group = 2, 4
    seen = []
    for w in range(n_shards):
        idxs = list(shard_chunks(w, n_shards, store.n_chunks, group=group))
        assert all((i // group) % n_shards == w for i in idxs)
        assert len(list(store.row_shard(w, n_shards, group=group))) == len(idxs)
        seen += idxs
    assert sorted(seen) == list(range(store.n_chunks))
    with pytest.raises(ValueError):
        list(shard_chunks(3, 3, 10))
    with pytest.raises(ValueError):
        list(shard_chunks(0, 3, 10, group=0))


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_unaligned_appends_round_trip(tmp_path, corpus, as_tensor):
    """Blocks need not align with chunks or shards, and may be numpy
    arrays or tensors."""
    A, B = (f32(x) for x in corpus.materialize())
    path = str(tmp_path / "ragged")
    with ViewStoreWriter(path, 40, 32, chunk=200, rows_per_shard=512) as w:
        lo = 0
        for size in (1, 333, 517, 700, 449):  # 2000 rows
            a, b = A[lo:lo + size], B[lo:lo + size]
            w.append(*((torch.from_numpy(a), torch.from_numpy(b)) if as_tensor else (a, b)))
            lo += size
    Am, Bm = ViewStoreReader(path).materialize()
    np.testing.assert_array_equal(Am.numpy(), A)
    np.testing.assert_array_equal(Bm.numpy(), B)


def test_extend_chunks_appends_and_republishes(tmp_path, corpus):
    A, B = (f32(x) for x in corpus.materialize())
    path = str(tmp_path / "grow")
    first = ingest_chunks(path, [(A[:1200], B[:1200])], chunk=200, rows_per_shard=500)
    grown = extend_chunks(path, [(A[1200:], B[1200:])], rows_per_shard=500)
    assert first.n == 1200 and grown.n == 2000
    assert len(grown.shards) == len(first.shards) + 2
    np.testing.assert_array_equal(grown.materialize()[0].numpy(), A)
    assert first.get_chunk(5)[0].shape[0] == 200  # the old snapshot still reads
    with pytest.raises(FileNotFoundError):
        ViewStoreWriter.append_to(str(tmp_path / "nothing"))


def test_writer_rejects_mismatched_blocks(tmp_path):
    w = ViewStoreWriter(str(tmp_path / "bad"), 8, 6, chunk=4)
    with pytest.raises(ValueError):
        w.append(np.zeros((3, 8)), np.zeros((2, 6)))  # row mismatch
    with pytest.raises(ValueError):
        w.append(np.zeros((3, 7)), np.zeros((3, 6)))  # feature mismatch
    with pytest.raises(ValueError):
        ingest_chunks(str(tmp_path / "empty"), iter(()), chunk=4)


def test_unpublished_store_is_unreadable(tmp_path):
    w = ViewStoreWriter(str(tmp_path / "unpub"), 8, 6, chunk=4)
    w.append(np.zeros((4, 8), np.float32), np.zeros((4, 6), np.float32))
    with pytest.raises(FileNotFoundError):
        ViewStoreReader(str(tmp_path / "unpub"))
    assert not store_exists(str(tmp_path / "unpub"))


def test_failed_ingest_leaves_no_debris(tmp_path):
    path = str(tmp_path / "failed")
    with pytest.raises(RuntimeError), ViewStoreWriter(path, 4, 4, chunk=2) as w:
        w.append(np.zeros((2, 4)), np.zeros((2, 4)))
        raise RuntimeError("killed")
    assert not os.path.exists(path) and not os.path.exists(path + ".tmp")


def test_verify_detects_corruption(tmp_path, corpus):
    path = str(tmp_path / "corrupt")
    r = ingest_planted(path, corpus, rows_per_shard=1000)
    r.verify()
    victim = os.path.join(path, r.shards[1].file_a)
    with open(victim, "r+b") as fh:
        fh.seek(-7, os.SEEK_END)
        byte = fh.read(1)
        fh.seek(-7, os.SEEK_END)
        fh.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(ValueError, match="hash mismatch"):
        ViewStoreReader(path).verify()


# --------------------------------------------------------------------------
# the format across the two packages
# --------------------------------------------------------------------------


def _chunks32():
    data = JPlanted(n=1000, da=24, db=16, rank=4, noise=0.4, seed=11, chunk=128)
    return [(f32(a), f32(b)) for a, b in data]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stores_are_byte_identical_across_packages(tmp_path, dtype):
    """The same rows written by either package give the same files,
    manifest included, so the same fingerprint; each package reads the
    other's store and verifies it, and the chunks agree bit for bit (bf16
    compared as its 16-bit patterns)."""
    chunks = _chunks32()
    j = j_ingest_chunks(str(tmp_path / "j"), iter(chunks), chunk=128, dtype=dtype,
                        rows_per_shard=300)
    t = ingest_chunks(str(tmp_path / "t"), iter(chunks), chunk=128, dtype=dtype,
                      rows_per_shard=300)
    files = sorted(os.listdir(j.path))
    assert files == sorted(os.listdir(t.path))
    for f in files:
        assert (Path(j.path) / f).read_bytes() == (Path(t.path) / f).read_bytes(), f
    t_reads_j, j_reads_t = ViewStoreReader(j.path), JReader(t.path)
    assert t_reads_j.fingerprint() == j.fingerprint() == j_reads_t.fingerprint()
    t_reads_j.verify()
    j_reads_t.verify()
    assert t_reads_j.nbytes == j.nbytes
    for i in range(j.n_chunks):
        want = [np.asarray(x) for x in j.get_chunk(i)]  # ml_dtypes bf16 in the reference
        got = t_reads_j.get_chunk(i)
        for w, g in zip(want, got):
            if dtype == "bfloat16":
                assert g.dtype == torch.bfloat16
                np.testing.assert_array_equal(g.view(torch.int16).numpy().view(np.uint16),
                                              w.view(np.uint16))
            else:
                np.testing.assert_array_equal(g.numpy(), w)


def test_bf16_store_rounds_like_the_reference(tmp_path):
    """f32 rows written to a bf16 store round to nearest even in both
    packages; read back, the port's bf16 upcast equals ml_dtypes'."""
    chunks = _chunks32()
    j = j_ingest_chunks(str(tmp_path / "j"), iter(chunks), chunk=128, dtype="bfloat16")
    t = ingest_chunks(str(tmp_path / "t"),
                      ((torch.from_numpy(a), torch.from_numpy(b)) for a, b in chunks),
                      chunk=128, dtype=torch.bfloat16)
    assert t.dtype == "bfloat16" and t.fingerprint() == j.fingerprint()
    np.testing.assert_array_equal(t.get_chunk(3)[0].float().numpy(),
                                  np.asarray(j.get_chunk(3)[0]).astype(np.float32))


def test_store_modules_need_no_ml_dtypes():
    """The card's machine has no ml_dtypes: the store, the checkpoints and
    the dtype helpers never name it."""
    src = ROOT / "src" / "repro_torch"
    files = [*sorted((src / "store").glob("*.py")), *sorted((src / "ckpt").glob("*.py")),
             src / "dtypes.py"]
    assert len(files) >= 8
    assert [str(f) for f in files if re.search(r"\bml_dtypes\b", f.read_text())] == []


# --------------------------------------------------------------------------
# prefetching
# --------------------------------------------------------------------------


def test_prefetcher_parity_and_stats(store):
    sync = list(store.iter_chunks())
    pf = ChunkPrefetcher(store.iter_raw(), depth=2)
    got = list(pf)
    pf.close()
    assert len(got) == len(sync)
    for (a0, b0), (a1, b1) in zip(sync, got):
        assert torch.equal(a0, a1) and torch.equal(b0, b1)
    st = pf.stats()
    assert (st["chunks"], st["rows"], st["bytes"]) == (store.n_chunks, store.n, store.nbytes)
    assert st["read_s"] >= 0 and st["io_stall_s"] >= 0
    sm = prefetched(store.iter_raw(), depth=0)
    assert sum(a.shape[0] for a, _ in sm) == store.n
    assert sm.stats()["rows"] == store.n
    assert sm.stats()["io_stall_s"] == sm.stats()["read_s"]
    with pytest.raises(ValueError):
        ChunkPrefetcher(iter(()), depth=0)


def test_prefetcher_propagates_source_errors(store):
    def poisoned():
        yield store.get_chunk(0)
        raise RuntimeError("disk on fire")

    pf = ChunkPrefetcher(poisoned(), depth=2)
    next(pf)
    with pytest.raises(RuntimeError, match="disk on fire"):
        next(pf)
    pf.close()  # delivered already: close does not raise it again


def test_prefetcher_close_raises_an_undelivered_error(store):
    """A read that failed before the consumer reached it is not lost."""
    def poisoned():
        yield store.get_chunk(0)
        raise RuntimeError("lost read")

    pf = ChunkPrefetcher(poisoned(), depth=2)
    next(pf)
    pf._thread.join(timeout=10)  # the producer has reached the failure and queued it
    assert not pf._thread.is_alive()
    with pytest.raises(RuntimeError, match="lost read"):
        pf.close()


def test_choose_pipeline_table():
    assert choose_pipeline(0.0001, 0.1) == (0, 4)  # page-cache reads: no thread
    assert choose_pipeline(0.1, 0.1) == (2, 1)  # balanced: double buffering, strict bound
    assert choose_pipeline(0.02, 0.1) == (2, 4)
    assert choose_pipeline(0.25, 0.1) == (4, 1)
    assert choose_pipeline(1.0, 0.05) == (8, 1)  # IO-bound: capped


# --------------------------------------------------------------------------
# URI dispatch
# --------------------------------------------------------------------------


class _MemFS(StoreFS):
    """Whole files in a dict, ``open``/``exists`` only: ``load_array``
    falls back to the base class's fetch-and-decode, like a remote
    backend."""

    def __init__(self, prefix):
        self.prefix = prefix
        self.files = {}

    def load_local(self, reader):
        for name in os.listdir(reader.path):
            self.files[f"{self.prefix}/{name}"] = (Path(reader.path) / name).read_bytes()

    def open(self, path, mode="rb"):
        import io

        if path not in self.files:
            raise FileNotFoundError(path)
        return io.BytesIO(self.files[path])

    def exists(self, path):
        return path in self.files


def test_uri_scheme_dispatch_mem(store):
    fs = _MemFS("tmem://corpus")
    fs.load_local(store)
    register_scheme("tmem", fs)
    r = ViewStoreReader("tmem://corpus")
    assert (r.n, r.da, r.db, r.chunk) == (store.n, store.da, store.db, store.chunk)
    assert r.fingerprint() == store.fingerprint()
    r.verify()
    for i in (0, 3, store.n_chunks - 1):
        for x, y in zip(store.get_chunk(i), r.get_chunk(i)):
            assert torch.equal(x, y)


def test_uri_unregistered_scheme_fails_helpfully():
    with pytest.raises(KeyError, match="register_scheme"):
        ViewStoreReader("gs-unregistered://bucket/corpus")


def test_file_uri_is_local(store):
    r = ViewStoreReader("file://" + os.path.abspath(store.path))
    assert r.fingerprint() == store.fingerprint()


def test_fsspec_memory_store_round_trip(store):
    fsspec = pytest.importorskip("fsspec", reason="fsspec is not installed")
    base = "memory://torch-fsstore"
    mem = fsspec.filesystem("memory")
    for name in os.listdir(store.path):
        with mem.open(f"{base}/{name}", "wb") as g:
            g.write((Path(store.path) / name).read_bytes())
    assert store_exists(base)
    r = ViewStoreReader(base)
    assert r.fingerprint() == store.fingerprint()
    r.verify()
    for i in (0, 4, store.n_chunks - 1):
        for x, y in zip(store.get_chunk(i), r.get_chunk(i)):
            assert torch.equal(x, y)
    cfg = tr.RCCAConfig(k=3, p=5, q=1, nu=0.01, center=True)
    local = PassRunner(store, cfg, prefetch=0, device="cpu").fit(seed=3)
    remote = PassRunner(r, cfg, prefetch=0, device="cpu").fit(seed=3)
    for f in ("Xa", "Xb", "rho", "Qa", "Qb"):
        assert torch.equal(getattr(local, f), getattr(remote, f)), f


def test_fsspec_missing_sdk_fails_at_first_io():
    """A remote scheme resolves through the lazy fsspec adapter even
    without its SDK; the SDK's absence surfaces at the first IO, with
    fsspec's install hint naming it."""
    import importlib.util

    pytest.importorskip("fsspec", reason="fsspec is not installed")
    missing = [(scheme, sdk) for scheme, sdk in (("gs", "gcsfs"), ("s3", "s3fs"), ("abfs", "adlfs"))
               if importlib.util.find_spec(sdk) is None]
    if not missing:
        pytest.skip("gcsfs, s3fs and adlfs are all installed: the lazy failure path is moot")
    scheme, sdk = missing[0]
    with pytest.raises(ImportError, match=sdk):
        ViewStoreReader(f"{scheme}://no-such-bucket/corpus")


# --------------------------------------------------------------------------
# the store-backed fit
# --------------------------------------------------------------------------

N, DA, DB, CHUNK = 2048, 48, 40, 128  # 16 chunks: two merge groups
CFG = dict(k=4, p=12, q=1, nu=0.01)


@pytest.fixture(scope="module")
def fit_store(tmp_path_factory):
    data = PlantedCCAData(n=N, da=DA, db=DB, rank=8, noise=0.5, seed=5, chunk=CHUNK)
    reader = ingest_planted(str(tmp_path_factory.mktemp("fit") / "store"), data)
    A, B = (f32(x) for x in data.materialize())
    return reader, A, B


def _omega(seed, kt):
    """The reference's materialized Ω for ``PRNGKey(seed)``, as numpy."""
    ka, kb = jax.random.split(jax.random.PRNGKey(seed))
    return (np.array(jax.random.normal(ka, (DA, kt), jnp.float32)),
            np.array(jax.random.normal(kb, (DB, kt), jnp.float32)))


@pytest.mark.parametrize("center", [False, True], ids=["raw", "centered"])
def test_store_fit_matches_reference_store_fit(fit_store, center):
    """The same store and Ω through both packages' PassRunner: ρ within
    1e-4 (f32 sums, other summation orders; measured ≤ 1e-6)."""
    reader, _, _ = fit_store
    jcfg, tcfg = jr.RCCAConfig(**CFG, center=center), tr.RCCAConfig(**CFG, center=center)
    Qa, Qb = _omega(4, tcfg.sketch)
    want = JPassRunner(reader.path, jcfg, engine="jnp", prefetch=2).fit(jax.random.PRNGKey(4))
    got = PassRunner(reader, tcfg, prefetch=2, device="cpu").fit(Qa, Qb)
    assert np.max(np.abs(got.rho.numpy() - np.asarray(want.rho))) <= 1e-4
    assert got.diagnostics["io"]["rows"] == want.diagnostics["io"]["rows"] == 2 * N


@pytest.mark.parametrize("omega", ["materialized", "seeded"])
@pytest.mark.parametrize("engine", ["kernels", "torch"])
def test_store_fit_is_bitwise_the_in_memory_fit(fit_store, engine, omega):
    reader, A, B = fit_store
    cfg = tr.RCCAConfig(**CFG, center=True)
    nc = N // CHUNK
    mem = PassEngine(cfg, engine=engine, device="cpu", omega=omega).run(
        StackedChunks(A.reshape(nc, CHUNK, DA), B.reshape(nc, CHUNK, DB)), seed=6)
    got = PassRunner(reader, cfg, engine=engine, omega=omega, device="cpu").fit(seed=6)
    for f in ("Xa", "Xb", "rho", "Qa", "Qb"):
        assert torch.equal(getattr(got, f), getattr(mem, f)), f
    io = got.diagnostics["io"]
    assert io["rows"] == 2 * N and not io["resumed"]
    assert [p["rows"] for p in io["passes"]] == [N, N]


def test_prefetch_auto_is_bitwise_a_fixed_depth(fit_store):
    reader, _, _ = fit_store
    cfg = tr.RCCAConfig(**CFG)
    fixed = PassRunner(reader, cfg, prefetch=2, device="cpu").fit(seed=0)
    sync = PassRunner(reader, cfg, prefetch=0, device="cpu").fit(seed=0)
    auto = PassRunner(reader, cfg, prefetch="auto", sync_chunks="auto", device="cpu").fit(seed=0)
    for res in (sync, auto):
        for f in ("Xa", "Xb", "rho", "Qa", "Qb"):
            assert torch.equal(getattr(fixed, f), getattr(res, f)), f
    chosen = auto.diagnostics["io"]["auto"]
    assert isinstance(chosen["prefetch"], int) and isinstance(chosen["sync_chunks"], int)
    assert auto.diagnostics["io"]["prefetch_depth"] == chosen["prefetch"]
    assert auto.diagnostics["io"]["rows"] == fixed.diagnostics["io"]["rows"]


def test_exec_fit_runs_local_and_refuses_other_topologies(fit_store):
    from repro_torch.exec import Local, Sharded, fit

    reader, _, _ = fit_store
    cfg = tr.RCCAConfig(**CFG)
    a = fit(reader.path, cfg, 2, device="cpu")
    b = fit(reader, cfg, 2, topology=Local(), prefetch=0, device="cpu")
    assert torch.equal(a.rho, b.rho)
    for topo in (Sharded(), "sharded", Sharded(devices=3)):  # ported: bitwise the Local fit
        assert torch.equal(fit(reader, cfg, 2, topology=topo, device="cpu").rho, a.rho)
    for topo in ("cluster", "hybrid"):  # ported; they need their directory
        with pytest.raises(ValueError, match="cluster_dir"):
            fit(reader, cfg, 2, topology=topo, device="cpu")


def test_open_source_seeks_by_name_and_n_full_chunks(fit_store, corpus, store):
    from repro.exec import n_full_chunks as j_full
    from repro_torch.exec import n_full_chunks, open_source

    reader = fit_store[0]
    src, first = open_source(reader.iter_chunks, 5)
    assert first == 5 and torch.equal(next(iter(src))[0], reader.get_chunk(5)[0])
    src, first = open_source(lambda: iter(corpus), 5)  # cannot seek: from 0
    assert first == 0
    tail = ingest_chunks(str(Path(store.path).parent / "tail"), [store.get_chunk(0)], chunk=150)
    for access in (reader, store, tail):  # no tail, no tail, a 50-row tail
        assert n_full_chunks(access) == j_full(access)
    assert n_full_chunks(tail) == 1 and tail.n_chunks == 2


def test_runner_refuses_the_card_without_cuda(fit_store):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PassRunner(fit_store[0], tr.RCCAConfig(**CFG))


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------


def test_cca_fit_data_flag(tmp_path, capsys):
    """``--ingest`` writes the rows the in-memory fit streams; the
    store-backed fit then gives the in-memory fit's ρ bitwise, and a
    second run reuses the published store."""
    from repro_torch.launch import cca_fit

    store = str(tmp_path / "fitstore")
    base = ["--smoke", "--device", "cpu"]
    mem = cca_fit.main(base)
    first = cca_fit.main(base + ["--data", store, "--ingest", "--ckpt-dir",
                                 str(tmp_path / "ck")])
    assert os.path.exists(os.path.join(store, "manifest.json"))
    again = cca_fit.main(base + ["--data", store, "--prefetch", "0"])
    assert torch.equal(first.result.rho, mem.result.rho)
    assert torch.equal(again.result.rho, mem.result.rho)
    out = capsys.readouterr().out
    assert "[cca] ingested 4096 rows" in out and "[cca] view store" in out
    assert re.search(r"\[cca\] pass 1 io: read [0-9.]+ s, stall [0-9.]+ s", out)
    assert "cursor saved at pass 1 chunk 8" in out
    assert first.io["rows"] == 2 * 4096


def test_cca_fit_store_flags_are_checked(tmp_path):
    from repro_torch.launch import cca_fit

    # --mode dist --data reads each rank's rows (tests/test_torch_hybrid.py); the
    # cursors stay stream mode's
    with pytest.raises(SystemExit, match="stream mode only"):
        cca_fit.main(["--smoke", "--device", "cpu", "--mode", "dist", "--data",
                      str(tmp_path / "s"), "--ckpt-dir", str(tmp_path / "c")])
    assert not os.path.exists(tmp_path / "s")
    with pytest.raises(SystemExit, match="need a store"):
        cca_fit.main(["--smoke", "--device", "cpu", "--resume"])


def test_cca_fit_ingest_refuses_a_full_disk(tmp_path, monkeypatch):
    import shutil
    from types import SimpleNamespace

    from repro_torch.launch import cca_fit

    monkeypatch.setattr(shutil, "disk_usage", lambda p: SimpleNamespace(free=1000))
    with pytest.raises(SystemExit, match="needs 0.01 GB"):
        cca_fit.main(["--smoke", "--device", "cpu", "--data", str(tmp_path / "full"), "--ingest"])
    assert not os.path.exists(tmp_path / "full") and not os.path.exists(tmp_path / "full.tmp")
