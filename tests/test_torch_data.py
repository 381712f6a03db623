"""The port's numpy data modules against the reference's, bit for bit,
and the port's two CCA examples run in-process on the CPU."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro.data import hashing as jhash
from repro.data import synthetic as jsyn
from repro_torch.data import HashingFeaturizer, SyntheticTokenStream, planted_views

ROOT = Path(__file__).resolve().parents[1]


def _docs(seed, n=64, vocab=50_000):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 40, n)
    lens[3] = 0  # an empty document
    return [rng.zipf(1.3, int(m)).clip(1, vocab - 1).astype(np.int64) for m in lens]


@pytest.mark.parametrize("n_slots,seed", [(256, 0), (4096, 1), (2**19, 2)])
def test_hashing_featurize_bitwise(n_slots, seed):
    docs = _docs(seed)
    mine, ref = HashingFeaturizer(n_slots, seed=seed), jhash.HashingFeaturizer(n_slots, seed=seed)
    toks = np.concatenate(docs)
    assert np.array_equal(mine.slots(toks), ref.slots(toks))
    assert np.array_equal(mine.signs(toks), ref.signs(toks))
    got, want = mine.featurize(docs), ref.featurize(docs)
    assert got.dtype == want.dtype == np.float32 and got.shape == (len(docs), n_slots)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n_slots,seed", [(256, 3), (2**19, 4)])
def test_hashing_featurize_batch_bitwise(n_slots, seed):
    rng = np.random.default_rng(seed)
    mat = rng.zipf(1.3, (50, 30)).clip(1, 49_999).astype(np.int64)
    mat[rng.random(mat.shape) < 0.25] = 0  # padding
    mat[7] = 0  # an all-padding row
    mine, ref = HashingFeaturizer(n_slots, seed=seed), jhash.HashingFeaturizer(n_slots, seed=seed)
    got, want = mine.featurize_batch(mat), ref.featurize_batch(mat)
    assert got.tobytes() == want.tobytes()
    assert not got[7].any()
    # a padded row of a batch is the featurized document of its tokens
    assert np.array_equal(got[:5], mine.featurize([r[r > 0] for r in mat[:5]]))


def test_token_stream_bitwise():
    mine = SyntheticTokenStream(vocab=1000, batch=4, seq=16, seed=3)
    ref = jsyn.SyntheticTokenStream(vocab=1000, batch=4, seq=16, seed=3)
    assert mine.get_batch(5).tobytes() == ref.get_batch(5).tobytes()
    for step, (x, y) in enumerate(zip(mine, ref)):
        assert x.dtype == np.int32 and x.shape == (4, 17)
        assert np.array_equal(x, y)
        if step == 3:
            break


@pytest.mark.parametrize("n,da,db,rank,noise", [(3000, 48, 40, 6, 0.4), (500, 17, 9, 8, 0.5)])
def test_planted_views_bitwise(n, da, db, rank, noise):
    got = planted_views(0, n=n, da=da, db=db, rank=rank, noise=noise)
    want = jsyn.planted_views(0, n=n, da=da, db=db, rank=rank, noise=noise)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _last_line(capsys):
    return capsys.readouterr().out.strip().splitlines()[-1]


def test_quickstart_example(capsys):
    out = _example("quickstart_torch").main(["--device", "cpu"])
    assert _last_line(capsys) == "OK"
    assert 0 <= out["gap"] < 0.05


def test_europarl_example(capsys, tmp_path):
    mod = _example("europarl_cca_torch")
    argv = ["--n", "2000", "--slots", "256", "--device", "cpu"]
    mem = mod.main(argv)
    assert _last_line(capsys) == "OK"
    # Horst from the rcca start raises the train objective (paper Table 2b)
    assert mem["horst_train"] > mem["train"]
    # the same rows through a view store: ingested, then reused
    for _ in range(2):
        store = mod.main(argv + ["--store", str(tmp_path / "store")])
        assert _last_line(capsys) == "OK"
        assert store["sum_rho"] == mem["sum_rho"]


def test_europarl_docs_match_reference_example():
    """The port's example hashes the documents the reference's does."""
    ref = _example("europarl_cca")
    mine = _example("europarl_cca_torch")
    for x, y in zip(mine.synth_paired_docs(300), ref.synth_paired_docs(300)):
        assert np.array_equal(x, y)
