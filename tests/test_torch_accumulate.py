"""The merge stack keeps closed merge groups in host memory.

At Europarl width one PowerStats is 8.6 GB; kept on the card, the
stack's closed groups outgrow its 80 GB partway through the corpus.  The
port copies each closed group to the host as it closes and merges there.
These tests hold it to the all-device tree: the reference's
accumulator (``repro.exec.accumulate``, every group kept where it was
made), bitwise, for 1 to 19 merge groups (the full Europarl corpus has
19) with and without a ragged tail; and they check that every closed
group takes the host path and that the stack keeps no pushed tensor.
"""

import weakref
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.exec import accumulate as jacc
from repro_torch.exec import accumulate as tacc

GROUP = 2


class Two(NamedTuple):
    y: object  # a (d, k̃)-like field
    n: object  # a scalar field


def _values(n_chunks, seed):
    """Magnitudes spread over 12 decades make f32 sums order-sensitive:
    equal bits mean equal reduction trees."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((n_chunks, 5, 3)) * 10.0 ** rng.integers(-6, 6, (n_chunks, 5, 3)))
    n = rng.standard_normal(n_chunks) * 10.0 ** rng.integers(-6, 6, n_chunks)
    return y.astype(np.float32), n.astype(np.float32)


def _fold(mod, zeros, to, y, n):
    acc = mod.SegmentedAccumulator(zeros, len(n), GROUP)
    for i in range(len(n)):
        acc.update(i, lambda s, a, b, *_: Two(s.y + a, s.n + b), to(y[i]), to(np.asarray(n[i])),
                   None, None)
    return acc


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged-tail"])
@pytest.mark.parametrize("n_groups", range(1, 20))
def test_host_stack_is_bitwise_the_all_device_tree(n_groups, ragged):
    n_chunks = n_groups * GROUP - int(ragged)
    y, n = _values(n_chunks, n_groups * 2 + int(ragged))
    got = _fold(tacc, lambda: Two(torch.zeros(5, 3), torch.zeros(())), torch.from_numpy, y, n)
    want = _fold(jacc, lambda: Two(jnp.zeros((5, 3), jnp.float32), jnp.zeros((), jnp.float32)),
                 jnp.asarray, y, n)
    assert got.groups_done == want.groups_done == n_groups
    g, w = got.result(), want.result()
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # result() folds a copy: asking twice gives the same bits
    assert all(torch.equal(a, b) for a, b in zip(g, got.result()))


@pytest.mark.parametrize("n_groups", [1, 2, 3, 8, 16, 19])
def test_closed_groups_take_the_host_path(monkeypatch, n_groups):
    """Every closed group is copied into a host buffer the stack owns,
    and the pushed tensors die.  New buffers are made only while the
    stack is deeper than ever before: the buffers of merged-away entries
    take the next copies, so the buffers made are the most entries ever
    live, popcount(m − 1) + 1 at the m-th push."""
    made, pushed = [], []
    real_host, real_push = tacc.host_buffer, tacc.PairwiseStack.push

    def counting_host(like, locked=None):
        made.append(real_host(like, locked))
        return made[-1]

    def watching_push(self, s, more=True):
        pushed.extend(weakref.ref(t) for t in s)
        real_push(self, s, more)

    monkeypatch.setattr(tacc, "host_buffer", counting_host)
    monkeypatch.setattr(tacc.PairwiseStack, "push", watching_push)
    y, n = _values(n_groups * GROUP, 0)
    acc = _fold(tacc, lambda: Two(torch.zeros(5, 3), torch.zeros(())), torch.from_numpy, y, n)
    tree = acc._tree
    assert acc.groups_done == n_groups and len(pushed) == 2 * n_groups
    assert len(made) == max(bin(m - 1).count("1") + 1 for m in range(1, n_groups + 1))
    assert len(tree.stack) == bin(n_groups).count("1")
    assert all(any(e is b for b in made) for e in tree.stack)  # host buffers it made
    assert all(r() is None for r in pushed)
    assert acc.result().y.device == tree.device
    assert acc.host_seconds >= 0.0


def test_host_buffer_makes_host_tensors_of_the_partials_shape():
    buf = tacc.host_buffer((Two, [((5, 3), torch.float32), ((), torch.float64)]))
    assert isinstance(buf, Two) and all(t.device.type == "cpu" for t in buf)
    assert [(tuple(t.shape), t.dtype) for t in buf] == [((5, 3), torch.float32),
                                                        ((), torch.float64)]


def test_worker_errors_surface_in_the_fold(monkeypatch):
    """Merges and buffers are made on the stack's worker thread; a fault
    there fails the fold, it is not lost with the thread."""
    real_host = tacc.host_buffer
    calls = []

    def failing_host(like, locked=None):
        calls.append(1)
        if len(calls) == 2:  # the buffer made in the background for push 2
            raise RuntimeError("host allocation failed")
        return real_host(like, locked)

    monkeypatch.setattr(tacc, "host_buffer", failing_host)
    y, n = _values(4 * GROUP, 0)
    with pytest.raises(RuntimeError, match="host allocation failed"):
        _fold(tacc, lambda: Two(torch.zeros(5, 3), torch.zeros(())), torch.from_numpy, y, n)


def test_card_partials_land_in_page_locked_buffers():
    """From the card, the stack's host buffers are page-locked for its
    lifetime (DMA-rate copies), the sum is still the all-device tree's,
    and the locks go when the stack does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: page-locking is a CUDA driver call "
                    "(chip_smoke.py drives it at Europarl width)")
    y, n = _values(5 * GROUP, 1)
    zeros = lambda: Two(torch.zeros(5, 3, device="cuda"), torch.zeros((), device="cuda"))
    to = lambda v: torch.from_numpy(v).cuda()
    got = _fold(tacc, zeros, to, y, n)
    want = _fold(jacc, lambda: Two(jnp.zeros((5, 3), jnp.float32), jnp.zeros((), jnp.float32)),
                 jnp.asarray, y, n)
    tree = got._tree
    locked = tree._locked
    assert locked and all(t.is_pinned() for e in tree.stack for t in e)
    for a, b in zip(got.result(), want.result()):
        assert a.device.type == "cuda"
        np.testing.assert_array_equal(a.cpu().numpy(), np.asarray(b))
    del got, tree
    assert locked == []


# --------------------------------------------------------------------------
# checkpointing: state, load_state, structure
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_chunks", [1, 8, 9, 16, 21])
@pytest.mark.parametrize("group", [2, 8])
def test_groups_completed_matches_reference(n_chunks, group):
    for nxt in range(n_chunks + 1):
        for total in (n_chunks, None):
            assert (tacc.SegmentedAccumulator.groups_completed(nxt, total, group)
                    == jacc.SegmentedAccumulator.groups_completed(nxt, total, group))


def _update(s, a, b, *_):
    return Two(s.y + a, s.n + b)


@pytest.mark.parametrize("n_chunks", [7, 8])
def test_state_round_trip_continues_bitwise(n_chunks):
    """Fold m chunks, snapshot the state as a checkpoint would (copies),
    rebuild at chunk m from ``structure`` + ``load_state`` and fold the
    rest: the bits of the uninterrupted fold, for every m (the open group
    is None exactly at group closes, the stack holds popcount(groups)
    entries)."""
    y, n = _values(n_chunks, 3)
    zeros = lambda: Two(torch.zeros(5, 3), torch.zeros(()))
    whole = _fold(tacc, zeros, torch.from_numpy, y, n).result()
    for m in range(n_chunks + 1):
        acc = tacc.SegmentedAccumulator(zeros, n_chunks, GROUP)
        for i in range(m):
            acc.update(i, _update, torch.from_numpy(y[i]), torch.from_numpy(np.asarray(n[i])),
                       None, None)
        st = acc.state()
        assert (st["current"] is None) == (m % GROUP == 0 or m == n_chunks)
        assert len(st["stack"]) == bin(acc.groups_done).count("1")
        saved = {"current": None if st["current"] is None else Two(*(t.clone() for t in
                                                                     st["current"])),
                 "stack": tuple(Two(*(t.clone() for t in e)) for e in st["stack"])}
        del acc, st
        back = tacc.SegmentedAccumulator.structure(zeros, n_chunks, GROUP, m)
        back.load_state(saved, "cpu")
        assert all(e is not s for e, s in zip(back._tree.stack, saved["stack"]))  # its own
        for i in range(m, n_chunks):
            back.update(i, _update, torch.from_numpy(y[i]), torch.from_numpy(np.asarray(n[i])),
                        None, None)
        back.flush_tail()
        assert all(torch.equal(a, b) for a, b in zip(back.result(), whole)), m


def test_structure_like_holds_no_memory():
    """A like-tree for a restore at Europarl width costs nothing: every
    entry is a meta tensor."""
    like = Two(torch.empty(2 ** 19, 2060, device="meta"), torch.empty((), device="meta"))
    for nxt, current, depth in [(0, False, 0), (3, True, 0), (8, False, 1), (13, True, 2),
                                (19, False, 2)]:
        acc = tacc.SegmentedAccumulator.structure(lambda: None, 19, 4, nxt, like=like)
        st = acc.state()
        assert (st["current"] is not None) == current
        assert len(st["stack"]) == depth == bin(acc.groups_done).count("1")
        for e in st["stack"] + ((st["current"],) if current else ()):
            assert all(t.device.type == "meta" for t in e)
            assert tuple(e.y.shape) == (2 ** 19, 2060)


def test_load_state_checks_the_stack_and_the_open_group():
    zeros = lambda: Two(torch.zeros(5, 3), torch.zeros(()))
    entry = zeros()
    acc = tacc.SegmentedAccumulator.structure(zeros, 9, GROUP, 6)  # 3 groups done
    with pytest.raises(ValueError, match="1 stack entries; 3 completed groups imply 2"):
        acc.load_state({"current": None, "stack": (entry,)})
    with pytest.raises(ValueError, match="open group"):
        tacc.SegmentedAccumulator.structure(zeros, 9, GROUP, 5).load_state(
            {"current": None, "stack": (entry, entry)})
