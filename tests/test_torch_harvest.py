"""Activation harvesting, the harvested fit, the serving driver and the
activation-CCA example of the port, on the CPU.

The reference's ``init`` trees are carried into the port
(``models.convert.from_jax_params``) for granite-3-2b's and gemma3-1b's
smoke configs in f32 (gemma3's vocabulary aligned to granite's, as
``examples/activation_cca.py`` does), so both packages harvest the same
rows from the same tokens.

Tolerances: rows within 1e-5 of the reference's largest magnitude (the
forward's f32 rounding, ``tests/test_torch_models.py``; the row scaling
adds one division); the harvested fit's ρ within 1e-4 of the
reference's on the same Ω (PERF.md §2; measured 3.6e-7 under both engines), Ω drawn by the
reference from its key and handed to the port as numpy, as
``tests/test_torch_rcca.py`` does.
"""

import contextlib
import dataclasses
import importlib.util
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import harvest as jharvest
from repro.core import rcca as jr
from repro.models import build_model as jbuild
from repro_torch.configs import get_config
from repro_torch.core import harvest
from repro_torch.core import rcca as tr
from repro_torch.data import SyntheticTokenStream
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
N_BATCHES, BATCH, SEQ = 8, 8, 32


def _pair(arch, key, vocab=None):
    jcfg = dataclasses.replace(jget(arch, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    if vocab is not None:
        jcfg = dataclasses.replace(jcfg, vocab=vocab)
        tcfg = dataclasses.replace(tcfg, vocab=vocab)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(key))
    tm = build_model(tcfg, device="cpu")
    from_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def models():
    """The example's two models, both packages, on the reference's weights."""
    a = _pair("granite-3-2b", 0)
    b = _pair("gemma3-1b", 1, vocab=a[0].cfg.vocab)
    return a, b


@pytest.fixture(scope="module")
def batches(models):
    stream = SyntheticTokenStream(vocab=models[0][0].cfg.vocab, batch=BATCH, seq=SEQ, seed=3)
    return [stream.get_batch(i)[:, :-1] for i in range(N_BATCHES)]


def _close(got, want, tol=TOL):
    got, want = got.numpy(), np.asarray(want, np.float64)
    assert got.dtype == np.float32 and got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * float(np.max(np.abs(want))), err


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("which", [0, 1])
def test_activation_views_match_reference(models, batches, which, normalize):
    jm, params, tm = models[which]
    tok = batches[0]
    want = jharvest.activation_views(jm, params, {"tokens": jnp.asarray(tok)},
                                     normalize=normalize)
    got = harvest.activation_views(tm, {"tokens": torch.from_numpy(tok)}, normalize=normalize)
    assert got.shape == (BATCH * SEQ, jm.cfg.d_model)
    _close(got, want)
    if normalize:  # the population std (ddof = 0) of each row is 1
        std = got.double().std(dim=1, correction=0)
        assert float((std - 1).abs().max()) < 1e-4


def test_paired_stream_matches_reference(models, batches):
    (ja, pa, ta), (jb, pb, tb) = models
    two = batches[:2]
    want = list(jharvest.paired_activation_stream(
        ja, pa, jb, pb, iter({"tokens": jnp.asarray(t)} for t in two)))
    got = list(harvest.paired_activation_stream(
        ta, tb, iter({"tokens": torch.from_numpy(t)} for t in two)))
    assert len(got) == len(want) == 2
    for (ga, gb), (wa, wb) in zip(got, want):
        _close(ga, wa)
        _close(gb, wb)


@pytest.mark.parametrize("which,frac", [(0, 0.5), (1, 0.5), (1, 0.1)])
def test_layer_views_match_reference(models, batches, which, frac):
    jm, params, tm = models[which]
    tok = batches[1]
    want = jharvest.layer_views(jm, params, {"tokens": jnp.asarray(tok)}, frac)
    got = harvest.layer_views(tm, {"tokens": torch.from_numpy(tok)}, frac)
    _close(got, want)


def test_bf16_model_gives_f32_rows(batches):
    model = build_model(get_config("granite-3-2b", smoke=True), device="cpu")
    rows = harvest.activation_views(model, {"tokens": torch.from_numpy(batches[0])})
    assert rows.dtype == torch.float32 and bool(torch.isfinite(rows).all())


def test_harvested_fit_matches_reference(models, batches):
    """The example's first experiment on both packages, from one Ω."""
    (ja, pa, ta), (jb, pb, tb) = models
    da, db = ja.cfg.d_model, jb.cfg.d_model
    kw = dict(k=8, p=24, q=1, nu=0.01, center=True)
    jcfg, tcfg = jr.RCCAConfig(**kw), tr.RCCAConfig(**kw)
    key = jax.random.PRNGKey(4)
    # the reference's harvest, jitted once a model: the same rows its
    # paired_activation_stream yields, made once for both passes
    views = [jax.jit(lambda p, t, m=m: jharvest.activation_views(m, p, {"tokens": t}))
             for m in (ja, jb)]
    rows = [(views[0](pa, jnp.asarray(t)), views[1](pb, jnp.asarray(t))) for t in batches]
    want = jr.randomized_cca_iterator(lambda: iter(rows), da, db, jcfg, key, engine="jnp")
    ka, kb = jax.random.split(key)  # Ω as the reference's init_Q draws it
    Qa = np.array(jax.random.normal(ka, (da, tcfg.sketch), jnp.float32))
    Qb = np.array(jax.random.normal(kb, (db, tcfg.sketch), jnp.float32))
    for engine in ("kernels", "torch"):
        got = tr.randomized_cca_iterator(
            lambda: harvest.paired_activation_stream(
                ta, tb, iter({"tokens": torch.from_numpy(t)} for t in batches)),
            da, db, tcfg, Qa, Qb, engine=engine, device="cpu")
        assert got.diagnostics["n"] == N_BATCHES * BATCH * SEQ
        gap = float(np.max(np.abs(got.rho.numpy() - np.asarray(want.rho))))
        assert gap <= 1e-4, (engine, gap)


@pytest.mark.parametrize("arch,prompt", [("granite-3-2b", 8), ("gemma3-1b", 20),
                                         ("gemma-7b", 8), ("starcoder2-7b", 8)])
def test_serve_driver_on_cpu(arch, prompt, capsys):
    rep = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", str(prompt), "--gen", "4"])
    out = capsys.readouterr().out
    assert f"[serve] arch={arch}-smoke prefill" in out and "on cpu:" in out
    tok = rep["tokens"]
    assert tok.shape == (2, 4)
    assert bool(((tok >= 0) & (tok < get_config(arch, smoke=True).vocab)).all())
    assert rep["device"] == "cpu" and rep["peak_gb"] is None


def test_serve_driver_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "granite-3-2b", "--smoke"])


def test_activation_cca_example_on_cpu():
    path = ROOT / "examples" / "activation_cca_torch.py"
    spec = importlib.util.spec_from_file_location("activation_cca_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = example.main(["--device", "cpu"])
    assert buf.getvalue().strip().splitlines()[-1] == "OK"
    assert out["gap"] > 0.5
    assert out["rho"].shape == (8,) and bool(((out["rho"] >= 0) & (out["rho"] <= 1)).all())
