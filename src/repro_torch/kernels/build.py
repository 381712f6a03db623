"""Build, load and launch the port's CUDA kernels.

Three sources in ``csrc/``, each compiled at first use by its own
``nvcc`` (all started together) into a shared library with a plain C
interface, loaded with ``ctypes``:

- ``gemm_f32.cu`` — the staged f32 products and the seeded stage;
- ``gemm_bf16.cu`` — the staged products on bf16 operands, the seeded
  stage's bf16 form and the bf16 generator;
- ``recompute_f32.cu`` — the fused recompute kernels, f32 and bf16,
  seeded or not;

on the headers ``gemm_ring.cuh`` (the f32 tile and its pipelined ring:
the staged f32 products and both phases of the fused f32 kernels, phase 2
of the fused bf16 ones), ``gemm_bf16.cuh`` (the bf16 tensor-core tile, on
``wgmma``), ``gemm_bf16_mma.cuh`` (the old ``mma.sync`` tile, kept as a
witness no entry point launches), ``mode.cuh`` (the tiles' output modes)
and ``rand.cuh`` (the Ω generator):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so csrc/<name>.cu

The libraries land in ``build/repro_torch_kernels/`` at the root of the
checkout (git ignores ``build/``), named by a hash of the source, every
header and the flags, so an edited source or header is rebuilt and an
unchanged one is loaded as it is.  Nothing here runs at import: the CPU
tests import every module of the port.

Every launch goes through :func:`launch`, which raises on a non-zero CUDA
error and adds one to that entry point's count in :data:`LAUNCHES` — the
proof that a run went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
#: The libraries: name → its one source.
LIBRARIES = {"gemm_f32": CSRC / "gemm_f32.cu", "gemm_bf16": CSRC / "gemm_bf16.cu",
             "recompute_f32": CSRC / "recompute_f32.cu"}
#: The headers every source may include; each goes into every digest.
HEADERS = (CSRC / "gemm_bf16.cuh", CSRC / "gemm_bf16_mma.cuh", CSRC / "gemm_ring.cuh",
           CSRC / "mode.cuh", CSRC / "rand.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_ptr, _i64, _int, _u32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
#: C signatures of the entry points, by library.
SIGNATURES = {
    "gemm_f32": {
        # x, q, p, M, N, K, tile, vec (plan.f32_tile, plan.copies), stream
        "gemm_nn_f32": [_ptr, _ptr, _ptr, _i64, _i64, _i64, _int, _int, _ptr],
        # x, y, o, M, N, K, accumulate, tile, vec, stream
        "gemm_tn_f32": [_ptr, _ptr, _ptr, _i64, _i64, _i64, _int, _int, _int, _ptr],
        # x, seed words, p, slab scratch, slab rows, M, N, K, tile, vec, stream
        "proj_stage_seeded_f32": [_ptr, _u32, _u32, _ptr, _ptr, _i64, _i64, _i64, _i64, _int,
                                  _int, _ptr],
        # out, rows, cols, r0, d, kt, seed words, stream
        "omega_fill_f32": [_ptr, _i64, _i64, _u32, _i64, _i64, _u32, _u32, _ptr],
        # tn, tile, int* out
        "gemm_f32_blocks_per_sm": [_int, _int, _ptr],
    },
    "gemm_bf16": {
        # x, q, p, M, N, K, copy widths of x and q in bytes (plan.copy_bytes), stream
        "gemm_nn_bf16": [_ptr, _ptr, _ptr, _i64, _i64, _i64, _int, _int, _ptr],
        # x, y, o, M, N, K, accumulate, copy widths of x and y, stream
        "gemm_tn_bf16": [_ptr, _ptr, _ptr, _i64, _i64, _i64, _int, _int, _int, _ptr],
        # as gemm_tn_f32, with a bf16 x
        "gemm_tn_bf16_f32": [_ptr, _ptr, _ptr, _i64, _i64, _i64, _int, _int, _int, _ptr],
        # x, seed words, p, slab scratch, slab rows, M, N, K, copy widths of x
        # and the slab, stream
        "proj_stage_seeded_bf16": [_ptr, _u32, _u32, _ptr, _ptr, _i64, _i64, _i64, _i64,
                                   _int, _int, _ptr],
        # as omega_fill_f32, bf16 out
        "omega_fill_bf16": [_ptr, _i64, _i64, _u32, _i64, _i64, _u32, _u32, _ptr],
        # the old mma.sync tile: x, q, y, M, N, K, tn, stream
        "gemm_bf16_mma_witness": [_ptr, _ptr, _ptr, _i64, _i64, _i64, _int, _ptr],
        # tn, int* out
        "gemm_bf16_blocks_per_sm": [_int, _ptr],
    },
    "recompute_f32": {
        # x, q, p, a2, y, n, kt, d, m2, lda2, accumulate, vec of phase 1
        # (plan.copies of x and q), vec of phase 2 (plan.copies of a2 and P),
        # stream
        "recompute_f32": [_ptr, _ptr, _ptr, _ptr, _ptr, _i64, _i64, _i64, _i64, _i64, _int,
                          _int, _int, _ptr],
        # the same arguments, on bf16 x and q (and a2 of the power form), with
        # the copy widths of x and q in bytes instead of phase 1's vec
        "projgram_bf16": [_ptr, _ptr, _ptr, _ptr, _ptr, _i64, _i64, _i64, _i64, _i64, _int,
                          _int, _int, _int, _ptr],
        "power_recompute_bf16": [_ptr, _ptr, _ptr, _ptr, _ptr, _i64, _i64, _i64, _i64, _i64,
                                 _int, _int, _int, _int, _ptr],
        # x, seed words, p, slab scratch, slab rows, a2, y, n, kt, d, m2, lda2,
        # accumulate, tile of the slabs before the last (plan.f32_tile), vec of
        # every slab's NN product (the last one's inside the fused launch),
        # vec of phase 2, stream
        "recompute_seeded_f32": [_ptr, _u32, _u32, _ptr, _ptr, _i64, _ptr, _ptr, _i64, _i64,
                                 _i64, _i64, _i64, _int, _int, _int, _int, _ptr],
        # the same arguments, on bf16 x and slab (and a2 of the power form),
        # with the copy widths of x and the slab instead of tile and vec
        "projgram_seeded_bf16": [_ptr, _u32, _u32, _ptr, _ptr, _i64, _ptr, _ptr, _i64, _i64,
                                 _i64, _i64, _i64, _int, _int, _int, _int, _ptr],
        "power_recompute_seeded_bf16": [_ptr, _u32, _u32, _ptr, _ptr, _i64, _ptr, _ptr, _i64,
                                        _i64, _i64, _i64, _i64, _int, _int, _int, _int, _ptr],
        # int* out
        "recompute_f32_blocks_per_sm": [_ptr],
        # power, int* out
        "recompute_bf16_blocks_per_sm": [_int, _ptr],
    },
}
#: Each library's ``cudaGetErrorString``.
ERROR_STRINGS = {"gemm_f32": "gemm_error_string", "gemm_bf16": "gemm_bf16_error_string",
                 "recompute_f32": "recompute_error_string"}
_LIB_OF = {fn: lib for lib, fns in SIGNATURES.items() for fn in fns}

#: Launches per Python entry point since the last :func:`reset_launches`.
LAUNCHES: Counter = Counter()

_LIBS: dict[str, ctypes.CDLL] = {}
#: ``{library: {"seconds": ..., "log": nvcc's output}}`` for each library
#: this process compiled (empty when all were found already built).
BUILD_LOG: dict = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from source at first use and need the CUDA toolkit")
    return str(path)


def _target(name: str) -> Path:
    digest = hashlib.sha256(b"".join(f.read_bytes() for f in (LIBRARIES[name], *HEADERS))
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build() -> dict[str, ctypes.CDLL]:
    """Compile every library that is not built yet — one ``nvcc`` each,
    all started together — load each once, and return them by name."""
    if _LIBS:
        return _LIBS
    todo = {name: _target(name) for name in LIBRARIES if not _target(name).exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = {}
        for name, target in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(LIBRARIES[name])],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, time.perf_counter())
        failed = []
        for name, (proc, tmp, t0) in jobs.items():
            log = proc.communicate()[0]
            BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "log": log}
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed for {LIBRARIES[name].name}:\n{log}")
            else:
                os.replace(tmp, todo[name])  # atomic: a reader never sees half a file
        if failed:
            raise RuntimeError("\n".join(failed))
    libs = {}
    for name in LIBRARIES:
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        err = getattr(lib, ERROR_STRINGS[name])
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        libs[name] = lib
    _LIBS.update(libs)
    return _LIBS


def blocks_per_sm(tn: bool, tile: int) -> int:
    """The blocks of the f32 NN (or TN) ring kernel on ``plan.F32_TILES[tile]``
    that the card keeps resident on one SM, by the occupancy API."""
    out = ctypes.c_int(0)
    rc = build()["gemm_f32"].gemm_f32_blocks_per_sm(int(tn), tile, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed with CUDA error {rc}")
    return out.value


def fused_f32_blocks_per_sm() -> int:
    """The blocks of the fused f32 kernels (``plan.FUSED_F32_TILE``) that the
    card keeps resident on one SM at the ring's pinned shared memory (the
    fewest of the four mode instances), by the occupancy API: the
    cooperative grid's blocks per SM."""
    return _occupancy("recompute_f32_blocks_per_sm")


def _occupancy(fn: str, *args: int) -> int:
    out = ctypes.c_int(0)
    rc = getattr(build()[_LIB_OF[fn]], fn)(*args, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"occupancy query {fn} failed with CUDA error {rc}")
    return out.value


def bf16_blocks_per_sm() -> dict[str, int]:
    """The blocks of each kernel on the bf16 tensor-core tile that the card
    keeps resident on one SM at the tile's dynamic shared memory, by the
    occupancy API: the staged NN and TN products and the fused projgram
    and power kernels (the cooperative grid's blocks per SM)."""
    return {"NN": _occupancy("gemm_bf16_blocks_per_sm", 0),
            "TN": _occupancy("gemm_bf16_blocks_per_sm", 1),
            "fused projgram": _occupancy("recompute_bf16_blocks_per_sm", 0),
            "fused power": _occupancy("recompute_bf16_blocks_per_sm", 1)}


def launch(entry: str, fn: str, *args) -> None:
    """Call C function ``fn`` on behalf of Python entry point ``entry``;
    raise on a CUDA error, else count the launch."""
    name = _LIB_OF[fn]
    lib = build()[name]
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        msg = getattr(lib, ERROR_STRINGS[name])(rc).decode()
        raise RuntimeError(f"{entry}: {fn} launch failed with CUDA error {rc} ({msg})")
    LAUNCHES[entry] += 1
