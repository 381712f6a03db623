"""Contract checker for the port's launch plans (RCCA101-108).

Port of ``repro/analysis/kernel_check.py``.  Every entry point launches
what a pure ``plan_*`` function of :mod:`repro_torch.kernels.plan`
describes (the same tile picks the wrappers pass to C), and
``repro_torch.kernels.KERNEL_REGISTRY`` maps each entry point and operand
form to its plan builder, its results, a call and its probe shapes.  The
checker holds each :class:`~repro_torch.kernels.plan.LaunchPlan` to the
rules below at the registry's small probes and at the main path's
shapes; at the small probes it also runs the entry point (its plain
version on the CPU, its kernel on the card).

  RCCA101  no surplus: the grid's dimensions are positive, its rank
           matches the plan's output axes, and no row or column of
           blocks lies past the output's last tile (a persistent grid:
           no more blocks than tiles).
  RCCA102  operand tiles: every block's tile of each input operand lies
           inside that operand padded to the tile (a grid sized from the
           wrong operand reads past it).
  RCCA103  coverage: the grid covers every output tile exactly once (a
           block per tile, or a persistent grid striding over all).
  RCCA104  resources: at most 1024 threads a block, at most the H100's
           227 KB of opt-in shared memory a block, a cooperative grid no
           larger than its resident blocks; on the card,
           :func:`check_occupancy`: the occupancy API's blocks per SM of
           every tile equal the plan's (``plan.F32_TILES``,
           ``plan.BF16_BLOCKS_PER_SM``, ``plan.ROWS_TILES``).
  RCCA105  dtypes: a launch that accumulates (its FLOPs) writes f32, and
           a bf16 operand never accumulates into bf16.
  RCCA106  the entry point agrees with its plan: at each small probe its
           results have the shapes and dtypes the registry declares, and
           the form's C function is one ``kernels.build`` binds, whose
           launches (``matmul.PARTS``) name every launch of the plan.
  RCCA107  the autotune cache's entries (reference: each re-plans
           cleanly).  The port has no autotune cache yet (ROADMAP Queue 1
           item 2): the gate reports this rule as not run.
  RCCA108  Ω's seed: the launches of a seeded plan take the two uint32
           words of ``omega_seeds`` as their only randomness (only its
           ``omega_fill`` launches take seed words, two each); an
           unseeded plan takes none.

The reference's VMEM budget (RCCA104) and index maps (RCCA102) are a
TPU's: a CUDA launch has shared memory and threads, and its blocks index
the output by ``blockIdx``, so the rules read the plan's grid, tile and
operand extents instead.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

from .report import Violation

#: The H100's opt-in shared memory per block: 227 KB (228 KB an SM less
#: the 1 KB the card reserves per block).
SMEM_OPT_IN = 227 * 1024
MAX_THREADS = 1024
RCCA107_NOTE = ("RCCA107 not run: the port has no autotune cache to validate "
                "(ROADMAP Queue 1 item 2)")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tag(name: str, probe: dict) -> str:
    return f"{name}[{'x'.join(str(v) for v in probe.values())}]"


def check_plan(p, *, where: str = "") -> List[Violation]:
    """RCCA101-105 on one :class:`~repro_torch.kernels.plan.LaunchPlan`."""
    from repro_torch.kernels import plan as kplan

    where = where or p.kernel
    out: List[Violation] = []

    def v(code: str, msg: str) -> None:
        out.append(Violation(code, where, 0, f"{p.kernel}: {msg}"))

    # -- RCCA101: grid geometry, no surplus blocks ----------------------------
    if not p.grid or any(g <= 0 for g in p.grid):
        v("RCCA101", f"empty or non-positive grid {p.grid}")
        return out
    if not p.out or len(p.out) != len(p.tile) or any(t <= 0 for t in p.tile):
        v("RCCA101", f"output {p.out} and tile {p.tile} do not pair up")
        return out
    if any(e <= 0 for e in p.out):
        v("RCCA101", f"empty output {p.out}")
        return out
    tiles = tuple(_cdiv(e, t) for e, t in zip(p.out, p.tile))
    n_tiles = math.prod(tiles)
    if p.persistent:
        if len(p.grid) != 1:
            v("RCCA101", f"a persistent grid has one axis, got {p.grid}")
            return out
        if p.grid[0] > n_tiles:
            v("RCCA101", f"{p.grid[0]} blocks for {n_tiles} tiles of {p.tile} on {p.out}: "
                         "surplus blocks")
    else:
        if len(p.grid) != len(p.out):
            v("RCCA101", f"grid {p.grid} has {len(p.grid)} axes, the output {len(p.out)}")
            return out
        for i, (g, t) in enumerate(zip(p.grid, tiles)):
            if g > t:
                v("RCCA101", f"grid axis {i}: {g} blocks for {t} tiles of {p.tile[i]} on "
                             f"{p.out[i]}: a surplus row or column of blocks")

    # -- RCCA102: every block's operand tiles inside the padded operands -------
    # A block per tile reaches grid[i] tiles along axis i.  A persistent
    # grid's phases each stride over their own operand's tiles, which must
    # lie in the tile space the grid was sized for.
    for j, ext in enumerate(p.ins):
        if len(ext) != len(p.out):
            v("RCCA102", f"input {j}: extents {ext} for {len(p.out)} output axes")
            continue
        for i, e in enumerate(ext):
            if e is None:
                continue
            pad = _cdiv(e, p.tile[i]) * p.tile[i]
            if p.persistent and pad > tiles[i] * p.tile[i]:
                v("RCCA102", f"input {j}, axis {i}: an operand of {e} padded to {pad} outside "
                             f"the {tiles[i] * p.tile[i]} the grid strides over")
            elif not p.persistent and p.grid[i] * p.tile[i] > pad:
                v("RCCA102", f"input {j}, axis {i}: blocks reach {p.grid[i] * p.tile[i]} of "
                             f"an operand of {e} padded to {pad}")

    # -- RCCA103: every output tile covered ------------------------------------
    if not p.persistent:
        for i, (g, t) in enumerate(zip(p.grid, tiles)):
            if g < t:
                v("RCCA103", f"grid axis {i}: {g} blocks for {t} tiles of {p.tile[i]} on "
                             f"{p.out[i]}: uncovered output tiles")

    # -- RCCA104: threads, shared memory, a resident cooperative grid ---------
    threads = math.prod(p.block)
    if not 0 < threads <= MAX_THREADS:
        v("RCCA104", f"{threads} threads a block (limit {MAX_THREADS})")
    if p.smem_bytes > SMEM_OPT_IN:
        v("RCCA104", f"{p.smem_bytes} B of shared memory a block (limit {SMEM_OPT_IN})")
    if p.persistent:
        per_sm = (kplan.F32_TILES[kplan.FUSED_F32_TILE][3] if p.kernel == "recompute_f32"
                  else kplan.BF16_BLOCKS_PER_SM)
        if p.grid[0] > per_sm * kplan.SMS:
            v("RCCA104", f"a cooperative grid of {p.grid[0]} blocks, {per_sm * kplan.SMS} "
                         "resident")

    # -- RCCA105: f32 accumulation ---------------------------------------------
    if p.flops > 0 and p.out_dtype != "float32":
        v("RCCA105", f"accumulates into {p.out_dtype}, not float32")
    if "bfloat16" in p.dtypes and p.out_dtype == "bfloat16":
        v("RCCA105", "a bf16 operand accumulates in bf16")
    return out


def _check_seeds(kdef, plans, where: str) -> List[Violation]:
    """RCCA108 over one probe's launches."""
    out = []
    seeded = [q for q in plans if q.seeds]
    for q in seeded:
        if not q.kernel.startswith("omega_fill"):
            out.append(Violation("RCCA108", where, 0,
                                 f"{q.kernel} takes {q.seeds} seed words: only the Ω "
                                 "generator draws randomness"))
        elif q.seeds != 2:
            out.append(Violation("RCCA108", where, 0,
                                 f"{q.kernel} takes {q.seeds} seed words, not omega_seeds' "
                                 "two uint32 words"))
    if kdef.seeded and not seeded:
        out.append(Violation("RCCA108", where, 0,
                             "a seeded entry point whose plan takes no seed"))
    if not kdef.seeded and seeded:
        out.append(Violation("RCCA108", where, 0,
                             "an unseeded entry point whose plan draws from a seed"))
    return out


def _check_names(kdef, plans, where: str) -> List[Violation]:
    """RCCA106's C side: the form's C function is bound, and every launch
    of the plan is one that function issues."""
    from repro_torch.kernels import build, matmul

    fn = kdef.fn
    bound = {f for sigs in build.SIGNATURES.values() for f in sigs}
    out = []
    if fn not in bound:
        out.append(Violation("RCCA106", where, 0,
                             f"form {kdef.dtypes} names C function {fn}, which "
                             "kernels.build does not bind"))
    issued = set(matmul.PARTS.get(fn, (fn,)))
    for name in dict.fromkeys(q.kernel for q in plans):
        if name not in issued:
            out.append(Violation("RCCA106", where, 0,
                                 f"the plan launches {name!r}, which {fn} does not issue "
                                 f"(it issues {sorted(issued)})"))
    return out


def _check_outputs(kdef, probe, device, where: str) -> List[Violation]:
    """RCCA106's Python side: the entry point's results at ``probe``."""
    try:
        got = kdef.call(dict(probe), device)
    except Exception as e:  # noqa: BLE001 — any failure to run is a finding
        return [Violation("RCCA106", where, 0, f"the entry point raised: {e!r}")]
    want = kdef.outputs(dict(probe))
    if len(got) != len(want):
        return [Violation("RCCA106", where, 0,
                          f"the entry point returns {len(got)} results, the plan declares "
                          f"{len(want)}")]
    out = []
    for i, (t, (shape, dtype)) in enumerate(zip(got, want)):
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            out.append(Violation("RCCA106", where, 0,
                                 f"result {i}: {tuple(t.shape)} {t.dtype}, the plan declares "
                                 f"{tuple(shape)} {dtype}"))
    return out


def check_kernel(kdef, *, device=None, run: bool = True) -> List[Violation]:
    """Every probe of one registered form: RCCA101-105 and RCCA108 on its
    plans at the small probes and the main path's shapes, RCCA106 (the
    C function, and with ``run`` the entry point's results on ``device``)
    at the small probes."""
    out: List[Violation] = []
    for probe, small in [(p, True) for p in kdef.probes] + [(p, False) for p in kdef.path]:
        where = _tag(kdef.name, probe)
        try:
            plans = kdef.plan(dict(probe))
        except Exception as e:  # noqa: BLE001 — a plan that cannot be made is a finding
            out.append(Violation("RCCA101", where, 0, f"plan builder raised: {e!r}"))
            continue
        if not plans:
            out.append(Violation("RCCA101", where, 0, "the plan issues no launch"))
            continue
        for q in plans:
            out.extend(check_plan(q, where=where))
        out.extend(_check_seeds(kdef, plans, where))
        if small:
            out.extend(_check_names(kdef, plans, where))
            if run:
                out.extend(_check_outputs(kdef, probe, device, where))
    return out


def check_occupancy(report: Optional[Callable[[str], None]] = None) -> List[Violation]:
    """RCCA104 on the card: each tile's blocks per SM by the occupancy API
    equal the plan's, staged and fused, f32 (``plan.F32_TILES``, the fused
    kernel on ``plan.FUSED_F32_TILE``, whose cooperative grid is sized from
    it), bf16 (``plan.BF16_BLOCKS_PER_SM`` at the wgmma tile's dynamic
    shared memory) and the serving segment tiles (``plan.ROWS_TILES``), or
    the waves and grids the plans model are not the card's.  ``report``
    takes one line per tile."""
    from repro_torch.kernels import build, plan

    say = report or (lambda line: None)
    out: List[Violation] = []

    def v(where: str, got, want) -> None:
        out.append(Violation("RCCA104", where, 0,
                             f"{got} blocks per SM by the occupancy API, the plan has {want}"))

    for tile, (bm, bn, threads, per_sm) in enumerate(plan.F32_TILES):
        got = [build.blocks_per_sm(tn, tile) for tn in (False, True)]
        say(f"f32 tile {tile} ({bm}×{bn}, {threads} threads): blocks per SM NN/TN {got}, "
            f"plan {per_sm}; {plan.ring_smem(tile)} B of shared memory asked")
        if got != [per_sm, per_sm]:
            v(f"f32 tile {tile}", got, per_sm)
        if tile == plan.FUSED_F32_TILE:
            fused = build.fused_f32_blocks_per_sm()
            say(f"fused f32 kernel (tile {tile}): blocks per SM {fused}, plan {per_sm}")
            if fused != per_sm:
                v("fused f32 kernel", fused, per_sm)
    for tile, (bm, bn, threads, per_sm) in enumerate(plan.ROWS_TILES):
        got = build.rows_blocks_per_sm(tile)
        say(f"serving segment tile {tile} ({bm}×{bn}, {threads} threads, "
            f"{plan.rows_smem(tile)} B of shared memory): blocks per SM {got}, plan {per_sm}")
        if got != per_sm:
            v(f"serving segment tile {tile}", got, per_sm)
    got = build.bf16_blocks_per_sm()
    say(f"bf16 wgmma tile (128×128, {plan.BF16_THREADS} threads, {plan.SMEM_BYTES_BF16} B of "
        f"dynamic shared memory): blocks per SM {got}, plan {plan.BF16_BLOCKS_PER_SM}")
    for kernel, n in got.items():
        if n != plan.BF16_BLOCKS_PER_SM:
            v(f"bf16 wgmma tile, {kernel}", n, plan.BF16_BLOCKS_PER_SM)
    return out


def check_registry(*, device="cuda",
                   report: Optional[Callable[[str], None]] = None) -> List[Violation]:
    """The kernel gate: every registered form (:func:`check_kernel`) on
    ``device`` and, on a card, :func:`check_occupancy`.  ``device="cuda"``
    on a host without CUDA raises: the gate never falls back to the CPU
    unasked."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the kernel gate runs on the card by default and this host has no "
                           "CUDA; pass device='cpu' (--device cpu) to check the plans against "
                           "the plain versions")
    from repro_torch.kernels import KERNEL_REGISTRY

    out: List[Violation] = []
    for name in sorted(KERNEL_REGISTRY):
        out.extend(check_kernel(KERNEL_REGISTRY[name], device=dev))
    if dev.type == "cuda":
        out.extend(check_occupancy(report))
    return out
