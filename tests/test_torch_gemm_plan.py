"""The staged f32 products' launch plan: the tile rule, the copy widths and
the tile set's agreement with ``csrc/gemm_ring.cuh``.

The kernels run only on the card (``chip_smoke.py``); what decides how they
are launched is Python, and is tested here on the CPU.
"""

import re

import pytest
import torch

from repro_torch.kernels import build, matmul, plan

CSRC = build.CSRC

# (M, N) of the main path's staged f32 outputs, and the share of idle slots
# the rule promises there (plan.f32_tile's docstring): proj_stage and the
# seeded stage's slabs (8192 × 2060), matmul_nn (4096 × 2060), the power
# sweep (2^19 × 2060), the p = 910 stage (8192 × 970); gram_sweep and
# matmul_tn (2060 × 2060)
MAIN_OUTPUTS = [((8192, 2060), 0.10), ((4096, 2060), 0.10), ((2 ** 19, 2060), 0.10),
                ((8192, 970), 0.10), ((2060, 2060), 0.35)]


def _cost(M, N, tile):
    bm, bn, _, per_sm = plan.F32_TILES[tile]
    return plan.tile_waves(M, N, tile)[1] * per_sm * bm * bn


@pytest.mark.parametrize("shape,promised", MAIN_OUTPUTS)
def test_tile_rule_leaves_at_most_the_promised_idle_share(shape, promised):
    M, N = shape
    tile = plan.f32_tile(M, N)
    assert plan.idle_share(M, N, tile) <= promised
    # the cheapest modelled launch of the set, and no worse than the one
    # 128 × 128 tile at two blocks per SM that every launch used before
    assert all(_cost(M, N, tile) <= _cost(M, N, other) for other in range(len(plan.F32_TILES)))
    old_tiles = plan.cdiv(M, 128) * plan.cdiv(N, 128)
    old_idle = 1 - M * N / (plan.cdiv(old_tiles, 2 * plan.SMS) * 2 * plan.SMS * 128 * 128)
    assert plan.idle_share(M, N, tile) <= old_idle


def test_tile_rule_waves_at_europarl_width():
    """At k̃ = 2060 the 128 × 64 tile fills 8192 rows in exactly 8 waves of
    264 blocks; the 2060 × 2060 products take the 128 × 128 tile; at
    k̃ = 970 the two tie and the larger wins."""
    assert plan.F32_TILES[plan.f32_tile(8192, 2060)][:2] == (128, 64)
    assert plan.tile_waves(8192, 2060, plan.f32_tile(8192, 2060)) == (2112, 8)
    assert plan.tile_waves(4096, 2060, plan.f32_tile(4096, 2060)) == (1056, 4)
    assert plan.F32_TILES[plan.f32_tile(2060, 2060)][:2] == (128, 128)
    assert _cost(8192, 970, 0) == _cost(8192, 970, 1)
    assert plan.F32_TILES[plan.f32_tile(8192, 970)][:2] == (128, 128)


def test_tile_set_matches_the_kernel_source():
    """``plan.F32_TILES`` lists ``gemm_ring.cuh``'s compiled tiles in order,
    with 8 × 8 outputs per thread, and the ring's depth is the plan's."""
    src = (CSRC / "gemm_ring.cuh").read_text()
    tiles = [tuple(map(int, m)) for m in
             re.findall(r"using Tile(?:\d) = Tile<(\d+), (\d+), (\d+)>;", src)]
    assert tiles == [(bm, bn, per_sm) for bm, bn, _, per_sm in plan.F32_TILES]
    # 8 × 8 outputs per thread, eight warps per SM on every tile
    assert all(threads == bm * bn // 64 and threads * per_sm == 256
               for bm, bn, threads, per_sm in plan.F32_TILES)
    assert f"constexpr int BK = {plan.RING_BK};" in src
    assert f"constexpr int STAGES = {plan.RING_STAGES};" in src
    assert re.search(r"case (\d+):", src.split("int launch(int tile")[1]) is not None
    # the fused f32 kernel's one tile is the plan's
    fused = (CSRC / "recompute_f32.cu").read_text()
    assert re.findall(r"using FusedTile = Tile(\d);", fused) == [str(plan.FUSED_F32_TILE)]


def test_every_compiled_bk_divides_the_seeded_slab():
    """A seeded slab edge falls on a staging step of every tile that
    contracts a slab: the f32 ring's (staged and fused) and the bf16 wgmma
    tile's (and of the old bf16 tile, kept as a witness); the ring's runs
    are 16 steps, the depth a masked K tail pads to, and the bf16 tile's
    unit — one k16 product from zero, one add — divides its stage."""
    bks = {f.name: int(m) for f in sorted(CSRC.glob("*.cuh"))
           for m in re.findall(r"constexpr int BK = (\d+);", f.read_text())}
    assert set(bks) == {"gemm_bf16.cuh", "gemm_bf16_mma.cuh", "gemm_ring.cuh"}
    assert all(plan.SEEDED_SLAB % bk == 0 for bk in bks.values())
    assert bks["gemm_ring.cuh"] == plan.RING_BK
    ring = (CSRC / "gemm_ring.cuh").read_text()
    (run,) = map(int, re.findall(r"constexpr int RUN = (\d+);", ring))
    assert run == 16 and plan.RING_BK % run == 0
    assert bks["gemm_bf16.cuh"] == plan.BF16_BK
    src = (CSRC / "gemm_bf16.cuh").read_text()
    (step,) = map(int, re.findall(r"constexpr int STEP = (\d+);", src))
    assert step == 16 and plan.BF16_BK % step == 0 and plan.SEEDED_SLAB % step == 0
    assert "m64n64k16.f32.bf16.bf16" in src  # each half of a step one wgmma, k16 deep


def test_the_single_stage_f32_tile_is_gone():
    """Every f32 tile of the port is the ring's: no source includes the old
    single-stage tile's header or names its function, and the build hashes
    exactly the headers that are there."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    assert sources
    for f in sources:
        text = f.read_text()
        assert '#include "gemm.cuh"' not in text, f.name
        assert "gemm_tile" not in text, f.name
    assert not (CSRC / "gemm.cuh").exists()
    assert set(build.HEADERS) == set(CSRC.glob("*.cuh"))


@pytest.mark.parametrize("row_stride,itemsize,want", [
    (67, 4, False),       # k̃ = 67: a 268-byte row
    (9001, 4, False),     # the ragged contraction of the NN stage, and M of the TN sweep
    (970, 4, False),      # k̃ = 970: 3,880 bytes, 8-byte aligned only
    (2060, 4, True),      # k̃ = 2060
    (2 ** 19, 4, True),   # a Europarl row of X
    (301, 2, False),      # a bf16 A of odd width
    (2 ** 19, 2, True),
])
def test_alignment_predicate(row_stride, itemsize, want):
    assert plan.vector_copies(4096, row_stride, itemsize) is want
    assert plan.vector_copies(4096 + itemsize, row_stride, itemsize) is False  # one element in


def test_launcher_sends_ragged_operands_to_the_4_byte_path():
    """The launcher's two extra arguments: the tile for the output and the
    copy widths (bit 0 A, bit 1 B) for these tensors' addresses and rows."""
    x, q = torch.empty(333, 9001), torch.empty(9001, 67)
    assert matmul._ring("gemm_nn_f32", 333, 67, matmul._operand(x, 9001),
                        matmul._operand(q, 67)) == (plan.f32_tile(333, 67), 0)
    a, p = torch.empty(8192, 2048), torch.empty(8192, 2060)
    assert matmul._ring("gemm_tn_f32", 2048, 2060, matmul._operand(a, 2048),
                        matmul._operand(p, 2060)) == (plan.f32_tile(2048, 2060), 3)
    # a window one element in: A no longer 16-byte aligned, B still
    assert plan.copies((a.data_ptr() + 4, 2048, 4), (p.data_ptr(), 2060, 4)) == 2
    assert matmul._ring("gemm_nn_bf16", 8192, 2060, (0, 8, 2), (0, 8, 2)) == ()


def test_staged_plans_take_the_picked_tile():
    (stage,) = plan.plan_proj_stage(8192, 2 ** 19, 2060)
    assert stage.grid == (33, 64) and stage.block == (128,)
    assert stage.smem_bytes == plan.ring_smem(1)
    (gram,) = plan.plan_gram_sweep(8192, 2060)
    assert gram.grid == (17, 17) and gram.block == (256,)
    (mixed,) = plan.plan_powerpass_sweep(8192, 2 ** 19, 2060, dtype=torch.bfloat16,
                                         p_dtype=torch.float32)
    assert mixed.kernel == "gemm_tn_bf16_f32" and mixed.grid == (33, 4096)
    # the pin: no more blocks fit an H100 SM than the plan counts
    for tile, (_, _, _, per_sm) in enumerate(plan.F32_TILES):
        for w in (4, 2):
            need = plan.ring_smem(tile, w) + plan.SMEM_RESERVED
            assert per_sm * need <= plan.SMEM_PER_SM < (per_sm + 1) * need


def _bf16_constants() -> dict:
    src = (CSRC / "gemm_bf16.cuh").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}


def test_bf16_tile_constants_match_the_kernel_source():
    """``plan``'s bf16 tile — threads, blocks per SM, ring depth and shared
    memory — is ``gemm_bf16.cuh``'s: two warpgroups on the 128 × 128 output
    tile, one block per SM, STAGES stages of A (BM × BK) and B (BK × BN) in
    bf16 plus the swizzle atoms' alignment."""
    c = _bf16_constants()
    assert (c["BM"], c["BN"]) == (plan.TILE, plan.TILE)
    assert c["THREADS"] == plan.BF16_THREADS == 2 * 128
    assert c["MIN_BLOCKS"] == plan.BF16_BLOCKS_PER_SM == 1
    assert (c["BK"], c["STAGES"], c["ALIGN"]) == (plan.BF16_BK, plan.BF16_STAGES,
                                                   plan.BF16_ALIGN)
    ring = c["STAGES"] * 2 * (c["BM"] * c["BK"] + c["BK"] * c["BN"])
    assert plan.SMEM_BYTES_BF16 == ring + c["ALIGN"] <= 232448  # an H100 block's opt-in
    # one block per SM by shared memory as well as by registers
    assert 2 * (plan.SMEM_BYTES_BF16 + plan.SMEM_RESERVED) > plan.SMEM_PER_SM


@pytest.mark.parametrize("entry,args,kernel,tiles", [
    (plan.plan_proj_stage, (8192, 2 ** 19, 2060), "gemm_nn_bf16", (17, 64)),
    (plan.plan_matmul_nn, (4096, 2 ** 18, 2060), "gemm_nn_bf16", (17, 32)),
    (plan.plan_powerpass_sweep, (4096, 2 ** 18, 2060), "gemm_tn_bf16", (17, 2048)),
    (plan.plan_gram_sweep, (4096, 2060), "gemm_tn_bf16", (17, 17)),
    (plan.plan_matmul_tn, (4096, 2 ** 18, 2060), "gemm_tn_bf16", (17, 2048)),
])
def test_bf16_staged_plans_take_the_wgmma_tile(entry, args, kernel, tiles):
    (p,) = entry(*args, dtype=torch.bfloat16)
    assert p.kernel == kernel and p.grid == tiles
    assert p.block == (plan.BF16_THREADS,) and p.smem_bytes == plan.SMEM_BYTES_BF16


def test_bf16_fused_and_seeded_plans_take_the_wgmma_tile():
    """The fused bf16 kernels' cooperative grid is one block per SM, at most
    as many as tiles; every seeded slab launch takes the tile too."""
    bf16 = torch.bfloat16
    launches = (plan.plan_projgram(8192, 2 ** 19, 970, dtype=bf16)
                + plan.plan_power_project_accumulate(8192, 1024, 2 ** 19, 970, dtype=bf16)
                + plan.plan_projgram_seeded(8192, 9001, 970, dtype=bf16)
                + plan.plan_power_project_accumulate_seeded(512, 256, 192, 32, dtype=bf16)
                + plan.plan_proj_stage_seeded(8192, 2 ** 19, 2060, dtype=bf16))
    fused = [p for p in launches if p.kernel in ("projgram_bf16", "power_recompute_bf16")]
    assert len(fused) == 4
    assert [p.grid for p in fused] == [(132,), (132,), (132,), (4,)]
    for p in launches:
        if p.kernel.startswith("omega_fill"):
            continue
        assert p.block == (plan.BF16_THREADS,) and p.smem_bytes == plan.SMEM_BYTES_BF16
        assert p.tc_flops > 0


@pytest.mark.parametrize("row_stride,want", [
    (2060, 8),     # Q or P at k̃ = 2060: a 4,120-byte row
    (970, 4),      # k̃ = 970: 1,940 bytes
    (67, 2),       # the ragged k̃ = 67: through registers
    (3, 2),        # k̃ = 3
    (2 ** 18, 16),  # a row of X: one model shard's
    (2 ** 19, 16),  # a Europarl row of X
])
def test_bf16_copy_width(row_stride, want):
    """Q and P at the main path's widths go to the narrower copies, X rows
    to the 16-byte one; a base one element in narrows any operand to 2."""
    assert plan.copy_bytes(4096, row_stride, 2) == want
    assert (want == 16) is plan.vector_copies(4096, row_stride, 2)
    assert plan.copy_bytes(4096 + 2, row_stride, 2) == 2


def test_bf16_launchers_pass_the_copy_widths():
    """The bf16 tile's C functions take (width of A, width of B) after their
    other arguments (a fused one: before phase 2's copy widths); the ring's
    and the rest take none."""
    x, q = torch.empty(8192, 2 ** 10, dtype=torch.bfloat16), torch.empty(2 ** 10, 2060,
                                                                          dtype=torch.bfloat16)
    a, b = matmul._operand(x, 2 ** 10), matmul._operand(q, 2060)
    for fn in ("gemm_nn_bf16", "gemm_tn_bf16", "proj_stage_seeded_bf16", "projgram_bf16",
               "power_recompute_bf16", "projgram_seeded_bf16", "power_recompute_seeded_bf16"):
        assert matmul._widths(fn, a, b) == (16, 8)
        at = -4 if fn in matmul.FUSED else -3
        assert build.SIGNATURES[build._LIB_OF[fn]][fn][at:at + 2] == [build._int, build._int]
    assert matmul._widths("gemm_nn_f32", a, b) == ()
    assert matmul._widths("gemm_tn_bf16_f32", a, b) == ()
    assert set(matmul.WGMMA) == {fn for forms in matmul.FORMS.values() for fn in forms.values()
                                 if fn.endswith("_bf16") and fn != "omega_fill_bf16"}


_CTYPES = {"const void*": build._ptr, "void*": build._ptr, "int*": build._ptr,
           "long long": build._i64, "int": build._int, "unsigned": build._u32}


def _c_entries(source: str) -> dict:
    """{function: [(C type, name), ...]} of the extern "C" block of a source."""
    block = source.split('extern "C" {', 1)[1]
    out = {}
    for name, params in re.findall(r"^\w[\w ]*?\**\s*(\w+)\(([^)]*)\)\s*\{", block, re.M):
        args = []
        for param in " ".join(params.split()).split(", "):
            ctype, arg = param.rsplit(" ", 1)
            while arg.startswith("*"):
                ctype, arg = ctype + "*", arg[1:]
            args.append((ctype, arg))
        out[name] = args
    return out


def test_fused_signatures_match_their_c_definitions():
    """Every entry of ``recompute_f32.cu`` that ``build.SIGNATURES`` binds
    takes, in the same order, the arguments its C definition takes — for a
    fused entry the tile and copy widths of phase 1 (f32: ``vec``, and the
    slabs' ``tile`` in the seeded form; bf16: ``wx``, ``wq``) and phase 2's
    ``vec2`` just before the stream — and the Python launcher passes
    exactly those."""
    entries = _c_entries((CSRC / "recompute_f32.cu").read_text())
    bound = build.SIGNATURES["recompute_f32"]
    assert set(bound) == set(entries) - {"recompute_error_string"}
    for fn, argtypes in bound.items():
        assert argtypes == [_CTYPES[ctype] for ctype, _ in entries[fn]], fn
    fused = [fn for fn in bound if not fn.endswith("_blocks_per_sm")]
    assert set(fused) == set(matmul.FUSED)
    x, q = (0, 2 ** 19, 4), (0, 970, 4)
    a2, p = (4096, 1024, 4), (8192, 970, 4)
    for fn in fused:
        names = [name for _, name in entries[fn]]
        want = {"recompute_f32": ["vec", "vec2"],
                "recompute_seeded_f32": ["tile", "vec", "vec2"]}.get(fn, ["wx", "wq", "vec2"])
        assert names[-len(want) - 1:] == want + ["stream"], fn
        assert names[-len(want) - 2] == "accumulate", fn
        extra = matmul._ring(fn, 8192, 970, x, q) + matmul._widths(fn, x, q) + matmul._phase2(
            fn, a2, p)
        assert len(extra) == len(want), fn
    # phase 2 at the p = 910 shapes: a 16-byte A, a 4-byte P (3,880-byte rows)
    assert matmul._phase2("recompute_f32", a2, p) == (1,)
    assert matmul._phase2("gemm_tn_f32", a2, p) == ()


@pytest.mark.parametrize("kt,slab_tile,grid", [(970, 0, 132), (2060, 1, 132), (67, 0, 64)])
def test_fused_f32_plans_take_the_fused_tile(kt, slab_tile, grid):
    """Both phases of the fused f32 kernel run the 128 × 128 ring tile: its
    block and pinned shared memory, and a cooperative grid of its blocks per
    SM on every SM, fewer where the larger phase has fewer tiles.  At the
    p = 910 shapes that is f32_tile's own pick for P; a seeded call's slabs
    before the last take f32_tile's pick (the 128 × 64 tile at k̃ = 2060)."""
    assert plan.F32_TILES[plan.FUSED_F32_TILE][:2] == (128, 128)
    assert plan.f32_tile(8192, 970) == plan.FUSED_F32_TILE
    launches = plan.plan_projgram(8192, 2 ** 19, kt) + plan.plan_power_project_accumulate(
        8192, 1024, 2 ** 19, kt) + plan.plan_projgram_seeded(8192, 9001, kt)
    assert plan.f32_tile(8192, kt) == slab_tile
    for p in launches:
        if p.kernel == "omega_fill_f32":
            continue
        i = plan.FUSED_F32_TILE if p.kernel == "recompute_f32" else slab_tile
        assert p.block == (plan.F32_TILES[i][2],) and p.smem_bytes == plan.ring_smem(i)
        if p.kernel == "recompute_f32":
            assert p.grid == (grid,)
