"""The port's model zoo (dense attention family) against the JAX reference.

For each of the four ported architectures' smoke configs in f32, the
reference's ``init(PRNGKey(0))`` tree is carried into the port by
``models.convert.from_jax_params``; both packages then compute the same
function.  Held against the reference: ``forward_hidden``, the
``forward_train`` logits, ``prefill`` and 4 decode steps (the tokens fed
to each step are fixed, not sampled).  gemma3's smoke window is 16: its
40-token case makes the local layers mask.

Tolerance: 1e-5 of the reference output's largest magnitude.  f32
rounding through a few layers of products of width ≤ 192 (√K·u ≈ 8e-7)
and a softmax stays near 1e-6; measured on the CPU the cases sit at
≤ 1.7e-6.  The port alone: prefill + decode against teacher forcing at
the reference's own 5e-4 (``tests/test_models_smoke.py``), one bf16
forward for shape and finiteness, and the families not ported raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import model_archs as jarchs
from repro.models import build_model as jbuild
from repro_torch.configs import get_config, model_archs
from repro_torch.models import LMModel, build_model
from repro_torch.models import config as tconfig
from repro_torch.models.attention import KVCache
from repro_torch.models.convert import from_jax_params

ARCHS = ["granite-3-2b", "gemma3-1b", "gemma-7b", "starcoder2-7b"]
NOT_PORTED = sorted(set(jarchs()) - set(ARCHS))
TOL = 1e-5
B = 2


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module")
def pair():
    """arch → (reference model, its params, the port's model on them)."""
    made = {}

    def get(arch):
        if arch not in made:
            jm = jbuild(_f32(jget(arch, smoke=True)))
            params = jm.init(jax.random.PRNGKey(0))
            tm = build_model(_f32(get_config(arch, smoke=True)), device="cpu", seed=1)
            from_jax_params(tm, jax.tree.map(np.asarray, params))
            made[arch] = (jm, params, tm)
        return made[arch]

    return get


def _tokens(vocab, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S), np.int32)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= tol * scale, (err, scale, err / scale)


CASES = [(a, 12) for a in ARCHS] + [("gemma3-1b", 40)]  # 40 > gemma3's window of 16


@pytest.mark.parametrize("arch,S", CASES)
def test_forward_matches_reference(pair, arch, S):
    jm, params, tm = pair(arch)
    tok = _tokens(jm.cfg.vocab, S, 1)
    hid, _ = jm.forward_hidden(params, {"tokens": jnp.asarray(tok)}, remat=False)
    got = tm.forward_hidden({"tokens": torch.from_numpy(tok)})
    assert got.shape == (B, S, jm.cfg.d_model) and got.dtype == torch.float32
    _close(got, hid)
    lg, _ = jm.forward_train(params, {"tokens": jnp.asarray(tok)}, remat=False)
    got_lg = tm.forward_train({"tokens": torch.from_numpy(tok)})
    assert got_lg.shape == (B, S, jm.cfg.vocab) and got_lg.dtype == torch.float32
    _close(got_lg, lg)


@pytest.mark.parametrize("arch,S", CASES)
def test_prefill_and_decode_match_reference(pair, arch, S):
    jm, params, tm = pair(arch)
    steps, T = 4, 64
    tok = _tokens(jm.cfg.vocab, S + steps, 2)
    jcache = jm.init_cache(B, T)
    jlg, jcache = jax.jit(jm.prefill)(params, jnp.asarray(tok[:, :S]), jcache)
    cache = tm.init_cache(B, T)
    lg, cache = tm.prefill(torch.from_numpy(tok[:, :S]), cache)
    assert lg.shape == (B, S, jm.cfg.vocab) and cache.pos == S
    _close(lg, jlg)
    jstep = jax.jit(jm.decode_step)
    for i in range(S, S + steps):
        jlg, jcache = jstep(params, jnp.asarray(tok[:, i:i + 1]), jcache)
        lg, cache = tm.decode_step(torch.from_numpy(tok[:, i:i + 1]), cache)
        assert lg.shape == (B, 1, jm.cfg.vocab) and cache.pos == i + 1
        _close(lg, jlg)
    # the caches hold the same keys and values, stacked (L, B, T, Kv, hd)
    _close(cache.k, jcache["layers"]["k"])
    _close(cache.v, jcache["layers"]["v"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """The port alone: prefill + one decode step == the teacher-forced
    logits of the same tokens (the reference's test and tolerance)."""
    cfg = _f32(get_config(arch, smoke=True))
    model = build_model(cfg, device="cpu")
    S = 16
    tok = torch.from_numpy(_tokens(cfg.vocab, S + 1, 3))
    full = model.forward_train({"tokens": tok})
    cache = model.init_cache(B, 64)
    _, cache = model.prefill(tok[:, :S], cache)
    logits, _ = model.decode_step(tok[:, S:S + 1], cache)
    err = float(torch.max(torch.abs(logits[:, 0] - full[:, S])))
    assert err < 5e-4, err


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_shapes_and_finite(arch):
    cfg = get_config(arch, smoke=True)
    assert cfg.dtype == "bfloat16"
    model = build_model(cfg, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    tok = torch.from_numpy(_tokens(cfg.vocab, 32, 4))
    logits = model.forward_train({"tokens": tok})
    assert logits.shape == (B, 32, cfg.vocab) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    hidden = model.forward_hidden({"tokens": tok})
    assert hidden.dtype == torch.bfloat16


def _port_cfg(c):
    """The reference's config as the port's dataclasses (same fields)."""
    kw = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
    kw = {k: _port_cfg(v) if dataclasses.is_dataclass(v) else v for k, v in kw.items()}
    return getattr(tconfig, type(c).__name__)(**kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    for smoke in (False, True):
        assert get_config(arch, smoke=smoke) == _port_cfg(jget(arch, smoke=smoke))
    assert model_archs() == [a for a in jarchs() if a in ARCHS]


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_unported_archs_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 6"):
        get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 6"):
        build_model(_port_cfg(jget(arch, smoke=True)), device="cpu")


def test_registry_keeps_the_paper_workload():
    assert get_config("europarl-cca").da == 2**19
    assert get_config("europarl_cca", smoke=True).name == jget("europarl-cca", smoke=True).name


def test_cache_overflow_raises():
    cfg = _f32(get_config("granite-3-2b", smoke=True))
    model = LMModel(cfg, device="cpu")
    cache = model.init_cache(1, 8)
    assert isinstance(cache, KVCache) and cache.k.shape == (cfg.n_layers, 1, 8, 2, 16)
    model.prefill(torch.zeros((1, 6), dtype=torch.int64), cache)
    with pytest.raises(ValueError, match="cannot take 3 more at 6"):
        model.decode_step(torch.zeros((1, 3), dtype=torch.int64), cache)


def test_from_jax_params_refuses_another_depth():
    jm = jbuild(_f32(jget("gemma-7b", smoke=True)))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    deeper = build_model(_f32(dataclasses.replace(get_config("gemma-7b", smoke=True),
                                                  n_layers=4)), device="cpu")
    with pytest.raises(ValueError, match="3 layers stacked, the model has 4"):
        from_jax_params(deeper, params)


def test_from_jax_params_carries_bf16_bits():
    """The smoke configs' own dtype: the reference's bf16 tree loads bit
    for bit (numpy holds it as ml_dtypes' bfloat16)."""
    jm = jbuild(jget("starcoder2-7b", smoke=True))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = from_jax_params(build_model(get_config("starcoder2-7b", smoke=True), device="cpu"),
                         params)
    state = tm.state_dict()
    want = {"embed": params["embed"], "lm_head": params["lm_head"],
            "layers.2.attn.wo": params["layers"]["attn"]["wo"][2],
            "layers.1.ffn.w_up": params["layers"]["ffn"]["w_up"][1]}
    for name, arr in want.items():
        assert str(arr.dtype) == "bfloat16" and state[name].dtype == torch.bfloat16
        got = state[name].view(torch.int16).numpy().view(np.uint16)
        assert np.array_equal(got, arr.view(np.uint16)), name
