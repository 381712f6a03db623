"""RandomizedCCA resident on a mesh of ranks (rows × features sharded).

Port of ``repro/core/rcca_dist.py`` over ``torch.distributed``.  Each
rank of a :class:`~repro_torch.launch.mesh.Mesh` holds one block of A and
B and runs the passes on it; where the reference runs one ``shard_map``
program, the port runs one process per rank, and ``lax.psum`` over mesh
axes becomes an ``all_reduce`` over the process group of those axes.

Sharding contract:

- rows (n)   → mesh axes ``row_axes`` (default ("pod", "data"));
- features   → mesh axis ``col_axis`` (default "model"); Qa/Qb/Ya/Yb are
  row-sharded over the same axis, so no da/db-sized tensor is held whole
  on any rank.

Per microbatch the only collectives are two sums of (mb × k̃) projected
activations over ``col_axis``.  Under ``engine="kernels"`` with a real
``col_axis`` they fold between the staged kernels (``collective="fused"``:
``stage_project`` → sum → ``sweep_accumulate`` / ``gram_accumulate``,
optionally int8 with error feedback, ``"fused-int8ef"``), or bracket the
unfused pair (``"unfused"``: ``project`` → sum → ``accumulate_tn``).  The
two run the same CUDA kernels in the same order, so they give the same
bits.  The d-sized accumulators are summed once per pass over
``row_axes``.

Two faults of the reference are fixed here:

- Under feature sharding the reference sums ‖A‖²_F and ‖B‖²_F
  (``tra``/``trb``) over ``row_axes`` only (``rcca_dist.py:224``,
  ``:318``), so ν's λ = ν·tr/d (``:461``) comes from one feature shard,
  depends on the mesh, and differs between the model ranks, whose rows of
  X then come from different whitenings.  The port sums them over the
  column axis too: λ and ρ do not depend on the mesh.
- The reference's ``dist_orth`` whitens in f32, which breaks at Europarl
  width as ``orth`` does (ROADMAP Queue 3).  The port's :func:`dist_orth`
  is the port's :func:`~repro_torch.core.linalg.orth` (f64 whitening,
  then a true CholeskyQR round) with both Grams summed over the column
  axis.

``finish`` is the port's f64 :func:`~repro_torch.core.rcca.finish`, run
redundantly on every rank on the same k̃ × k̃ statistics.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import DEFAULT_DEVICE, resolve_device
from ..distributed import bucketed_accumulate, psum_int8_ef
from ..exec.engine import pass_schedule
from ..kernels import ops as kops
from .linalg import orth, sym
from .rcca import DEFAULT_ENGINE, RCCAConfig, RCCAResult, _sq_norm, finish, resolve_engine

f32 = torch.float32
COLLECTIVES = ("fused", "fused-int8ef", "unfused")


# --------------------------------------------------------------------------
# collective helpers
# --------------------------------------------------------------------------


def _psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over ``axes`` (in place when there is a group)."""
    return mesh.all_reduce(x if x.is_contiguous() else x.contiguous(), axes)


def _psum_int8(x: torch.Tensor, mesh, axes, err):
    """:func:`~repro_torch.distributed.psum_int8_ef` over ``axes``, timed
    with the mesh's other collectives."""
    group = mesh.group(axes)
    if group is None:
        return psum_int8_ef(x, None, err)
    with mesh.timed(x.device):
        return psum_int8_ef(x, group, err)


def dist_orth(Y: torch.Tensor, mesh, col_axis) -> torch.Tensor:
    """Orthonormalize a row-sharded tall matrix: :func:`orth` (f64
    eigh-whitened round, then one CholeskyQR round) with both Grams
    summed over ``col_axis``.  All collectives are k̃ × k̃ (f64, then f32);
    on a rank that holds all of Y's rows it is ``orth(Y)`` bitwise."""
    return orth(Y, gram=lambda M: _psum(M.T @ M, mesh, col_axis))


def shard_block(x, mesh, row_axes, col_axis) -> torch.Tensor:
    """This rank's block of a global 2-D array laid out as the reference's
    ``P(row_axes, col_axis)``: dim 0 split evenly over ``row_axes`` (in the
    mesh's row-major order), dim 1 over ``col_axis`` (None: not split).
    Returns ``x`` itself when nothing is cut, else a compact copy (a row
    slice of a contiguous array is contiguous, and would keep the whole
    array alive as a view)."""
    n, d = x.shape
    rs, cs = mesh.size(row_axes), mesh.size(col_axis)
    if n % rs or d % cs:
        raise ValueError(f"a ({n}, {d}) array does not split evenly over {rs} row and "
                         f"{cs} column shards")
    if rs == cs == 1:
        return x
    r, c = mesh.index(row_axes), mesh.index(col_axis)
    block = x[r * (n // rs):(r + 1) * (n // rs), c * (d // cs):(c + 1) * (d // cs)]
    return block.clone(memory_format=torch.contiguous_format)


def gather_features(x: torch.Tensor, mesh, col_axis) -> torch.Tensor:
    """The rows of a ``P(col_axis, None)``-sharded array (Qa, Xa, ...)
    gathered over ``col_axis``: the whole array, on every rank of the
    group."""
    group = mesh.group(col_axis)
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size(col_axis))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


# --------------------------------------------------------------------------
# data passes (a/b are this rank's row × feature blocks)
# --------------------------------------------------------------------------


def _microbatches(a: torch.Tensor, mb):
    n_loc = a.shape[0]
    if mb is None or mb >= n_loc:
        return 1, n_loc
    if n_loc % mb:
        raise ValueError(f"local rows {n_loc} not divisible by microbatch {mb}")
    return n_loc // mb, mb


def _check_collective(collective: str) -> None:
    if collective not in COLLECTIVES:
        raise ValueError(f"unknown collective mode {collective!r}")


def _row_stats(am, bm, sa, sb, tra, trb):
    """Fold a microbatch's column sums and squared norms in place."""
    sa += torch.sum(am, dim=0, dtype=f32)
    sb += torch.sum(bm, dim=0, dtype=f32)
    tra += _sq_norm(am)
    trb += _sq_norm(bm)


def _reduce_row_stats(mesh, row_axes, col_axis, sa, sb, tra, trb, n):
    """Sum the row statistics over the rows; ‖·‖²_F over the features too
    (the reference sums them over ``row_axes`` only, so its λ depends on
    the mesh)."""
    sa, sb = _psum(sa, mesh, row_axes), _psum(sb, mesh, row_axes)
    all_axes = row_axes if col_axis is None else (*row_axes, col_axis)
    tr = _psum(torch.stack([tra, trb]), mesh, all_axes)
    nn = _psum(torch.tensor([float(n)], dtype=f32, device=sa.device), mesh, row_axes)
    return sa, sb, tr[0], tr[1], nn[0]


def power_pass_local(a, b, Qa, Qb, *, mesh, row_axes, col_axis, microbatch=None,
                     compute_dtype=torch.bfloat16, int8_reduce=False, reduce_buckets=1,
                     reduce_dtype=None, engine="torch", collective="fused"):
    """One range-finder pass over this rank's blocks → global (Ya, Yb,
    stats): Ya/Yb sharded like Qa/Qb (features over ``col_axis``, the
    same on every row rank), plus the centering and λ statistics.

    ``engine="kernels"`` runs the per-microbatch products in the port's
    CUDA kernels: the fused chunk update (``ops.power_pass_chunk``) when
    ``col_axis`` is None, else the collective chosen by ``collective``
    (module docstring).  ``engine="torch"`` runs plain products.

    Perf knobs of the end-of-pass Y sum over ``row_axes``:
    ``reduce_dtype`` casts it first; ``int8_reduce`` sums it with
    blockwise int8 (one :func:`psum_int8_ef` per row axis, no residual
    carried); ``reduce_buckets`` > 1 issues it in column buckets
    (:func:`bucketed_accumulate`).
    """
    _check_collective(collective)
    nb, mb = _microbatches(a, microbatch)
    da_l, kt = Qa.shape
    db_l = Qb.shape[0]
    cd = compute_dtype
    kernels = resolve_engine(engine) == "kernels"
    fused_col = kernels and col_axis is not None and collective != "unfused"
    use_ef = fused_col and collective == "fused-int8ef"
    Qa_c, Qb_c = Qa.to(cd), Qb.to(cd)

    dev = a.device
    Ya = torch.zeros((da_l, kt), dtype=f32, device=dev)
    Yb = torch.zeros((db_l, kt), dtype=f32, device=dev)
    sa = torch.zeros((da_l,), dtype=f32, device=dev)
    sb = torch.zeros((db_l,), dtype=f32, device=dev)
    tra, trb = (torch.zeros((), dtype=f32, device=dev) for _ in range(2))
    ea = eb = None  # error-feedback residuals, carried across microbatches
    for i in range(nb):  # lax.scan in the reference
        am, bm = a[i * mb:(i + 1) * mb], b[i * mb:(i + 1) * mb]
        am_c, bm_c = am.to(cd), bm.to(cd)
        if kernels and col_axis is None:
            # features unsharded: the fused chunk update applies as it is
            kops.power_pass_chunk(am_c, bm_c, Qa_c, Qb_c, out=(Ya, Yb))
        elif fused_col:
            # the partial P of the local feature shard, summed at the
            # phase boundary, then swept into Y
            pb = kops.stage_project(bm_c, Qb_c).to(cd)
            pa = kops.stage_project(am_c, Qa_c).to(cd)
            if use_ef:
                pb, eb = _psum_int8(pb, mesh, col_axis, eb)
                pa, ea = _psum_int8(pa, mesh, col_axis, ea)
            else:
                pb = _psum(pb, mesh, col_axis)
                pa = _psum(pa, mesh, col_axis)
            kops.sweep_accumulate(am_c, pb, out=Ya)
            kops.sweep_accumulate(bm_c, pa, out=Yb)
        else:
            # projected activations: the only per-microbatch collectives
            if kernels:
                pb = kops.project(bm_c, Qb_c).to(cd)
                pa = kops.project(am_c, Qa_c).to(cd)
            else:
                pb = bm_c @ Qb_c
                pa = am_c @ Qa_c
            if col_axis is not None:
                pb = _psum(pb, mesh, col_axis)
                pa = _psum(pa, mesh, col_axis)
            if kernels:
                Ya += kops.accumulate_tn(am_c, pb)
                Yb += kops.accumulate_tn(bm_c, pa)
            else:
                Ya += am_c.T.to(f32) @ pb.to(f32)
                Yb += bm_c.T.to(f32) @ pa.to(f32)
        _row_stats(am, bm, sa, sb, tra, trb)

    def reduce_Y(Y):
        # one d-sized sum per pass, over the row axes only
        if reduce_dtype is not None:
            Y = Y.to(reduce_dtype)
        if int8_reduce:
            for ax in row_axes:
                Y, _ = _psum_int8(Y, mesh, (ax,), None)
            return Y.to(f32)
        if reduce_buckets > 1:
            group = mesh.group(row_axes)
            if group is None:
                return Y.to(f32)
            with mesh.timed(Y.device):
                return bucketed_accumulate(Y, group, reduce_buckets).to(f32)
        return _psum(Y, mesh, row_axes).to(f32)

    Ya, Yb = reduce_Y(Ya), reduce_Y(Yb)
    sa, sb, tra, trb, n = _reduce_row_stats(mesh, row_axes, col_axis, sa, sb, tra, trb,
                                            nb * mb)
    return Ya, Yb, sa, sb, tra, trb, n


def final_pass_local(a, b, Qa, Qb, *, mesh, row_axes, col_axis, microbatch=None,
                     compute_dtype=torch.bfloat16, engine="torch", collective="fused"):
    """Final pass: the projected covariances Ca, Cb, F (paper lines
    14-18) and the row statistics, the same on every rank.

    ``engine="kernels"``: the fused chunk update (``ops.final_pass_chunk``)
    with unsharded features, else the collective chosen by
    ``collective``: staged P, its sum, then ``gram_accumulate`` for Ca, Cb
    and ``sweep_accumulate`` for F (fused), or ``project`` → sum → three
    ``accumulate_tn`` (unfused)."""
    _check_collective(collective)
    nb, mb = _microbatches(a, microbatch)
    da_l, kt = Qa.shape
    db_l = Qb.shape[0]
    cd = compute_dtype
    kernels = resolve_engine(engine) == "kernels"
    fused_col = kernels and col_axis is not None and collective != "unfused"
    use_ef = fused_col and collective == "fused-int8ef"
    Qa_c, Qb_c = Qa.to(cd), Qb.to(cd)

    dev = a.device
    Ca, Cb, F = (torch.zeros((kt, kt), dtype=f32, device=dev) for _ in range(3))
    sa = torch.zeros((da_l,), dtype=f32, device=dev)
    sb = torch.zeros((db_l,), dtype=f32, device=dev)
    tra, trb = (torch.zeros((), dtype=f32, device=dev) for _ in range(2))
    ea = eb = None
    for i in range(nb):
        am, bm = a[i * mb:(i + 1) * mb], b[i * mb:(i + 1) * mb]
        am_c, bm_c = am.to(cd), bm.to(cd)
        if kernels and col_axis is None:
            dCa, dCb, dF = kops.final_pass_chunk(am_c, bm_c, Qa_c, Qb_c)
            Ca += dCa
            Cb += dCb
            F += dF
        elif fused_col:
            pa = kops.stage_project(am_c, Qa_c).to(cd)
            pb = kops.stage_project(bm_c, Qb_c).to(cd)
            if use_ef:
                pa, ea = _psum_int8(pa, mesh, col_axis, ea)
                pb, eb = _psum_int8(pb, mesh, col_axis, eb)
            else:
                pa = _psum(pa, mesh, col_axis)
                pb = _psum(pb, mesh, col_axis)
            Ca += kops.gram_accumulate(pa)
            Cb += kops.gram_accumulate(pb)
            # F = PaᵀPb is the sweep contraction with Pa as the operand
            F += kops.sweep_accumulate(pa, pb)
        else:
            if kernels:
                pa = kops.project(am_c, Qa_c).to(cd)
                pb = kops.project(bm_c, Qb_c).to(cd)
            else:
                pa = am_c @ Qa_c
                pb = bm_c @ Qb_c
            if col_axis is not None:
                pa = _psum(pa, mesh, col_axis)
                pb = _psum(pb, mesh, col_axis)
            if kernels:
                Ca += kops.accumulate_tn(pa, pa)
                Cb += kops.accumulate_tn(pb, pb)
                F += kops.accumulate_tn(pa, pb)
            else:
                pa32, pb32 = pa.to(f32), pb.to(f32)
                Ca += pa32.T @ pa32
                Cb += pb32.T @ pb32
                F += pa32.T @ pb32
        _row_stats(am, bm, sa, sb, tra, trb)
    # Ca/Cb/F are the same within a model group (P already summed over
    # col_axis): sum over the rows only
    Ca, Cb, F = (_psum(t, mesh, row_axes) for t in (Ca, Cb, F))
    sa, sb, tra, trb, n = _reduce_row_stats(mesh, row_axes, col_axis, sa, sb, tra, trb,
                                            nb * mb)
    return Ca, Cb, F, sa, sb, tra, trb, n


# --------------------------------------------------------------------------
# full distributed solve
# --------------------------------------------------------------------------


def dist_randomized_cca(A_l, B_l, cfg: RCCAConfig, Qa0_l, Qb0_l, mesh=None, *,
                        row_axes=("pod", "data"), col_axis="model", microbatch=None,
                        compute_dtype=f32, engine: str = DEFAULT_ENGINE, topology=None,
                        collective: str = "fused", on_pass_complete=None,
                        device=DEFAULT_DEVICE) -> RCCAResult:
    """Algorithm 1 on this rank's blocks of row- and feature-sharded A
    (n × da), B (n × db).

    ``A_l``, ``B_l``: this rank's ``P(row_axes, col_axis)`` blocks;
    ``Qa0_l``, ``Qb0_l``: its ``P(col_axis, None)`` rows of Ω (the RNGs of
    the two packages cannot be matched, so Ω is passed in, as in
    :func:`~repro_torch.core.rcca.randomized_cca`; :func:`shard_block`
    cuts both).  Every rank of ``mesh`` calls this with its own blocks.
    Arrays are taken on ``device`` in ``cfg.dtype``.

    A ``Sharded`` ``topology`` supplies ``mesh`` and ``col_axis`` in one
    argument.  Axes absent from the mesh are dropped, and so is a model
    axis of size 1: it shards nothing, so the passes take the fused
    chunk updates instead of a collective over one rank.
    ``on_pass_complete(pass_idx, kind)`` is called after each pass's
    statistics are summed (before the power pass's orth).

    Returns this rank's rows of Xa, Xb, Qa, Qb (gather them with
    :func:`gather_features`) and the top-k ρ, the same on every rank.
    """
    _check_collective(collective)
    engine = resolve_engine(engine)
    if topology is not None:
        if topology.mesh is None and mesh is None:
            raise ValueError("resident-mode Sharded topology needs an explicit mesh "
                             "(its axis names define the row/feature sharding)")
        mesh = topology.mesh if mesh is None else mesh
        col_axis = topology.col_axis
    if mesh is None:
        raise ValueError("dist_randomized_cca needs a mesh (or a topology)")
    row_axes = tuple(ax for ax in row_axes if ax in mesh.axis_names)
    if col_axis is not None and col_axis not in mesh.axis_names:
        col_axis = None
    if col_axis is not None and mesh.shape[col_axis] == 1:
        col_axis = None
    dev = resolve_device(device)
    A, B = (torch.as_tensor(x, device=dev, dtype=cfg.dtype) for x in (A_l, B_l))
    Qa, Qb = (torch.as_tensor(x, device=dev, dtype=cfg.dtype) for x in (Qa0_l, Qb0_l))
    cs = mesh.size(col_axis)
    da, db = A.shape[1] * cs, B.shape[1] * cs
    if Qa.shape[0] != A.shape[1] or Qb.shape[0] != B.shape[1]:
        raise ValueError(f"Ω blocks {tuple(Qa.shape)}, {tuple(Qb.shape)} do not match the "
                         f"feature blocks of A {tuple(A.shape)}, B {tuple(B.shape)}")
    kw = dict(mesh=mesh, row_axes=row_axes, col_axis=col_axis, microbatch=microbatch,
              compute_dtype=compute_dtype, engine=engine, collective=collective)

    for pass_idx, kind in pass_schedule(cfg.q):
        if kind != "power":
            break
        Ya, Yb, sa, sb, _, _, nn = power_pass_local(A, B, Qa, Qb, **kw)
        if on_pass_complete is not None:
            on_pass_complete(pass_idx, kind)
        if cfg.center:
            mu_bQ = _psum((sb / nn) @ Qb.to(f32), mesh, col_axis)
            mu_aQ = _psum((sa / nn) @ Qa.to(f32), mesh, col_axis)
            Ya = Ya - nn * torch.outer(sa / nn, mu_bQ)
            Yb = Yb - nn * torch.outer(sb / nn, mu_aQ)
        Qa = Qb = None  # the old bases are not needed past the centering
        Qa = dist_orth(Ya.to(cfg.dtype), mesh, col_axis)
        del Ya
        Qb = dist_orth(Yb.to(cfg.dtype), mesh, col_axis)
        del Yb

    Ca, Cb, F, sa, sb, tra, trb, nn = final_pass_local(A, B, Qa, Qb, **kw)
    if on_pass_complete is not None:
        on_pass_complete(cfg.q, "final")
    Qa32, Qb32 = Qa.to(f32), Qb.to(f32)
    if cfg.center:
        qa = _psum(Qa32.T @ (sa / nn), mesh, col_axis)
        qb = _psum(Qb32.T @ (sb / nn), mesh, col_axis)
        Ca = Ca - nn * torch.outer(qa, qa)
        Cb = Cb - nn * torch.outer(qb, qb)
        F = F - nn * torch.outer(qa, qb)
    QtQa = _psum(sym(Qa32.T @ Qa32), mesh, col_axis)
    QtQb = _psum(sym(Qb32.T @ Qb32), mesh, col_axis)
    if cfg.nu is not None:
        lam_a, lam_b = cfg.nu * tra / da, cfg.nu * trb / db
    else:
        lam_a = torch.tensor(cfg.lam_a, dtype=f32, device=dev)
        lam_b = torch.tensor(cfg.lam_b, dtype=f32, device=dev)
    # finish (paper lines 19-25): the same small math on every rank, the
    # local rows of Q
    Xa, Xb, S, _, _ = finish(Ca, Cb, F, QtQa, QtQb, Qa32, Qb32, nn, lam_a, lam_b, cfg.k)
    return RCCAResult(Xa=Xa, Xb=Xb, rho=S, Qa=Qa, Qb=Qb,
                      diagnostics={"lam_a": lam_a, "lam_b": lam_b, "n": int(nn)})
