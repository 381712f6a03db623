"""Kill → resume of store-backed fits, and the checkpoints under it.

A fit killed mid-pass and resumed from its pass cursor must give the
uninterrupted ``RCCAResult`` bitwise: the cursor holds the exact f32
accumulators (the open merge group and the closed groups' stack) and the
update sequence is fixed.  Both engines, materialized and seeded Ω, and
three kill points: inside a power-pass merge group, exactly at a group's
close (the open group is then None), and inside the final pass.  The
resumed fit reads fewer than (q + 1)·n rows.  Every resume guard raises
(store fingerprint, engine, hyper-parameters, merge group, Ω's
provenance, cursor layout), and a resume with no cursor is a fresh fit.
"""

import dataclasses
import json
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro.ckpt import load_flat as j_load_flat
from repro_torch.ckpt import CheckpointManager, load_flat, load_metadata, restore_pytree, save_pytree
from repro_torch.core import rcca as tr
from repro_torch.data import PlantedCCAData
from repro_torch.store import PassRunner, ingest_planted


class Kill(Exception):
    """A simulated crash mid-pass."""


N, CHUNK = 1200, 75  # 16 chunks a pass: two merge groups of 8
CFG = tr.RCCAConfig(k=4, p=8, q=1, nu=0.01, center=True)
SEED = 7


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    data = PlantedCCAData(n=N, da=32, db=24, rank=5, noise=0.4, seed=9, chunk=CHUNK)
    return ingest_planted(str(tmp_path_factory.mktemp("resume") / "store"), data)


def _runner(store, ckpt=None, **kw):
    return PassRunner(store, kw.pop("cfg", CFG), ckpt_dir=ckpt, device="cpu", **kw)


def _same(r1, r2):
    for f in ("Xa", "Xb", "rho", "Qa", "Qb"):
        assert torch.equal(getattr(r1, f), getattr(r2, f)), f"{f} differs after resume"


def _kill(runner, kill_at):
    def crash(pass_idx, chunk_idx, *_):
        if (pass_idx, chunk_idx) == kill_at:
            raise Kill

    with pytest.raises(Kill):
        runner.fit(seed=SEED, on_chunk=crash)


# kill point → the cursor the resume starts from (cursors every 2 chunks)
KILLS = {"mid-power-group": ((0, 5), (0, 4)), "at-group-close": ((0, 8), (0, 8)),
         "mid-final-pass": ((1, 11), (1, 10))}


@pytest.mark.parametrize("omega", ["materialized", "seeded"])
@pytest.mark.parametrize("kill", list(KILLS))
@pytest.mark.parametrize("engine", ["kernels", "torch"])
def test_kill_resume_is_bitwise_the_uninterrupted_fit(store, tmp_path, engine, kill, omega):
    kill_at, (pass_idx, next_chunk) = KILLS[kill]
    baseline = _runner(store, engine=engine, omega=omega).fit(seed=SEED)
    ck = str(tmp_path / "ck")
    _kill(_runner(store, ck, engine=engine, omega=omega, ckpt_every=2), kill_at)
    meta = CheckpointManager(ck).metadata()
    assert (meta["pass_idx"], meta["next_chunk"]) == (pass_idx, next_chunk)
    leaves, _ = load_flat(os.path.join(ck, f"step_{pass_idx * 1_000_000 + next_chunk - 1:09d}"))
    # the open group: absent exactly at a group's close
    assert any(k.startswith("acc/current/") for k in leaves) == (next_chunk % 8 != 0)
    # a seeded pass 0 under the kernels engine carries the seeds, not Ω
    seeds = omega == "seeded" and engine == "kernels" and pass_idx == 0
    assert tuple(leaves["Qa"].shape) == ((2,) if seeds else (32, CFG.sketch))
    resumed = _runner(store, ck, engine=engine, omega=omega).fit(seed=SEED, resume=True)
    io = resumed.diagnostics["io"]
    assert io["resumed"] and io["cursor_restored"]["next_chunk"] == next_chunk
    # the folded prefix is not read again
    assert io["rows"] == 2 * N - (pass_idx * 16 + next_chunk) * CHUNK < 2 * N
    _same(baseline, resumed)


@pytest.fixture(scope="module")
def killed_cursor(store, tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("guards") / "ck")
    _kill(_runner(store, ck, engine="torch", ckpt_every=2), (0, 5))
    return ck


def _other_store(tmp_path):
    return ingest_planted(str(tmp_path / "other"),
                          PlantedCCAData(n=N, da=32, db=24, rank=5, seed=10, chunk=CHUNK))


def _tampered(ck, tmp_path):
    """A copy of the cursor directory whose cursor claims another layout."""
    import shutil

    dst = str(tmp_path / "tampered")
    shutil.copytree(ck, dst)
    mgr = CheckpointManager(dst)
    path = os.path.join(mgr._step_dir(mgr.latest_step()), "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["metadata"]["cursor_fmt"] = 1
    with open(path, "w") as f:
        json.dump(manifest, f)
    return dst


GUARDS = {
    "fingerprint": ("different store", lambda s, ck, tp: _runner(_other_store(tp), ck,
                                                                 engine="torch")),
    "engine": ("engine", lambda s, ck, tp: _runner(s, ck, engine="kernels")),
    "algo": ("hyper-parameters", lambda s, ck, tp: _runner(
        s, ck, engine="torch", cfg=dataclasses.replace(CFG, p=CFG.p + 2))),
    "merge_group": ("merge_group", lambda s, ck, tp: _runner(s, ck, engine="torch",
                                                             merge_group=4)),
    "omega": ("omega", lambda s, ck, tp: _runner(s, ck, engine="torch", omega="seeded")),
    "cursor_fmt": ("layout", lambda s, ck, tp: _runner(s, _tampered(ck, tp), engine="torch")),
}


@pytest.mark.parametrize("guard", list(GUARDS))
def test_resume_guards(store, killed_cursor, tmp_path, guard):
    """A cursor binds the store's content, the engine, the
    hyper-parameters, the merge structure, Ω's provenance and its own
    layout."""
    match, make = GUARDS[guard]
    with pytest.raises(ValueError, match=match):
        make(store, killed_cursor, tmp_path).fit(seed=SEED, resume=True)


def test_matching_runner_resumes_the_guarded_cursor(store, killed_cursor):
    res = _runner(store, killed_cursor, engine="torch").fit(seed=SEED, resume=True)
    assert res.diagnostics["io"]["resumed"]
    _same(_runner(store, engine="torch").fit(seed=SEED), res)


def test_resume_without_cursor_is_a_fresh_fit(store, tmp_path):
    res = _runner(store, str(tmp_path / "empty"), prefetch=0).fit(seed=SEED, resume=True)
    assert not res.diagnostics["io"]["resumed"]
    assert res.diagnostics["io"]["cursor_restored"] is None
    _same(_runner(store, prefetch=0).fit(seed=SEED), res)


def test_cursors_are_reported_and_kept(store, tmp_path):
    ck = str(tmp_path / "ck")
    res = _runner(store, ck, ckpt_every=4, keep=2).fit(seed=SEED)
    saved = res.diagnostics["io"]["cursors_saved"]
    assert [(c["pass_idx"], c["next_chunk"]) for c in saved] == [
        (p, c) for p in (0, 1) for c in (4, 8, 12, 16)]
    assert all(c["bytes"] > 0 and c["save_s"] >= 0 for c in saved)
    steps = sorted(os.listdir(ck))
    assert steps == ["step_001000011", "step_001000015"]  # the newest two


# --------------------------------------------------------------------------
# the checkpoints
# --------------------------------------------------------------------------


class Two(NamedTuple):
    y: object
    n: object


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"acc": {"current": None,
                    "stack": (Two(torch.randn(5, 3, generator=g), torch.tensor(2.5)),
                              Two(torch.randn(5, 3, generator=g), torch.tensor(-1.0)))},
            "Qa": torch.randn(4, 3, generator=g).to(torch.bfloat16),
            "Qb": torch.tensor([7, 2 ** 32 - 1], dtype=torch.int64)}


def _meta(tree):
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(_meta(v) for v in tree))
    return type(tree)(_meta(v) for v in tree)


def test_checkpoint_round_trip_bitwise(tmp_path):
    tree = _tree()
    d = str(tmp_path / "c")
    nbytes = save_pytree(tree, d, metadata={"why": "test"})
    assert nbytes == 2 * (15 + 1) * 4 + 12 * 2 + 2 * 8
    got = restore_pytree(_meta(tree), d)
    assert got["acc"]["current"] is None and isinstance(got["acc"]["stack"][1], Two)
    assert got["Qa"].dtype == torch.bfloat16 and torch.equal(got["Qa"], tree["Qa"])
    assert torch.equal(got["Qb"], tree["Qb"])
    for s, t in zip(got["acc"]["stack"], tree["acc"]["stack"]):
        assert all(torch.equal(u, v) for u, v in zip(s, t))
    assert load_metadata(d) == {"why": "test"}
    flat, meta = load_flat(d)
    assert sorted(flat) == ["Qa", "Qb", "acc/stack/0/n", "acc/stack/0/y", "acc/stack/1/n",
                            "acc/stack/1/y"]
    # the reference's layout: its loader reads the f32 leaves as they are
    jflat, jmeta = j_load_flat(d)
    np.testing.assert_array_equal(jflat["acc/stack/0/y"], flat["acc/stack/0/y"].numpy())
    assert jmeta == meta


def test_checkpoint_restore_checks_the_like_tree(tmp_path):
    tree = _tree()
    d = str(tmp_path / "c")
    save_pytree(tree, d)
    wrong_shape = _meta(tree)
    wrong_shape["Qa"] = torch.empty((4, 4), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="'Qa'"):
        restore_pytree(wrong_shape, d)
    wrong_dtype = _meta(tree)
    wrong_dtype["Qa"] = torch.empty((4, 3), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="'Qa'"):
        restore_pytree(wrong_dtype, d)
    extra = _meta(tree)
    extra["acc"]["current"] = Two(torch.empty(5, 3, device="meta"), torch.empty((), device="meta"))
    with pytest.raises(ValueError, match="holds leaves"):
        restore_pytree(extra, d)


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "m"), keep=2)
    assert mgr.latest_step() is None and mgr.metadata() is None
    assert mgr.restore({}) == (None, None)
    for step in (3, 10, 7):
        mgr.save(step, {"x": torch.full((2,), float(step))}, metadata={"k": step})
    os.makedirs(os.path.join(mgr.root, "step_000000099.tmp"))  # a killed writer's debris
    assert mgr.latest_step() == 10
    assert sorted(d for d in os.listdir(mgr.root) if not d.endswith(".tmp")) == [
        "step_000000007", "step_000000010"]
    tree, meta = mgr.restore({"x": torch.empty(2, device="meta")})
    assert meta == {"step": 10, "k": 10} and torch.equal(tree["x"], torch.full((2,), 10.0))
    assert mgr.metadata(7)["k"] == 7
