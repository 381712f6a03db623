"""Build, load and launch the port's CUDA kernels.

The source ``csrc/gemm_f32.cu`` (which includes ``csrc/rand.cuh``) is
compiled at first use with one ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <build>/gemm_f32-<hash>.so csrc/gemm_f32.cu

The library lands in ``build/repro_torch_kernels/`` at the root of the
checkout (git ignores ``build/``), named by a hash of every source it
compiles and the flags, so an edited source or header is rebuilt and an
unchanged one is loaded as it is.  Nothing here runs at import: the CPU
tests import every module of the port.

Every launch goes through :func:`launch`, which raises on a non-zero
``cudaGetLastError()`` and adds one to that entry point's count in
:data:`LAUNCHES` — the proof that a run went through the kernels.
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

SOURCE = Path(__file__).resolve().parent / "csrc" / "gemm_f32.cu"
#: Everything the one nvcc compiles: the source and the headers it includes.
SOURCES = (SOURCE, SOURCE.parent / "rand.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_ptr, _i64, _int, _u32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
#: C signatures of the library's entry points.
SIGNATURES = {
    "gemm_nn_f32": [_ptr, _ptr, _ptr, _i64, _i64, _i64, _ptr],
    "gemm_tn_f32": [_ptr, _ptr, _ptr, _i64, _i64, _i64, _int, _ptr],
    # x, seed words, p, slab scratch, slab rows, M, N, K, stream
    "proj_stage_seeded_f32": [_ptr, _u32, _u32, _ptr, _ptr, _i64, _i64, _i64, _i64, _ptr],
    # out, rows, cols, r0, d, kt, seed words, stream
    "omega_fill_f32": [_ptr, _i64, _i64, _u32, _i64, _i64, _u32, _u32, _ptr],
}

#: Launches per Python entry point since the last :func:`reset_launches`.
LAUNCHES: Counter = Counter()

_LIB: ctypes.CDLL | None = None
#: ``{"seconds": ..., "log": nvcc's output}`` when this process compiled
#: the library (empty when it was found already built).
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


def _target() -> Path:
    digest = hashlib.sha256(b"".join(src.read_bytes() for src in SOURCES)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{SOURCE.stem}-{digest}.so"


def build() -> ctypes.CDLL:
    """Compile the source if it is not built yet, load the library once,
    and return it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    target = _target()
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        BUILD_LOG.update(seconds=time.perf_counter() - t0, log=proc.stdout)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{proc.stdout}")
        os.replace(tmp, target)  # atomic: a reader never sees half a file
    lib = ctypes.CDLL(str(target))
    for fn, argtypes in SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.gemm_error_string.argtypes = [ctypes.c_int]
    lib.gemm_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def launch(entry: str, fn: str, *args) -> None:
    """Call C function ``fn`` on behalf of Python entry point ``entry``;
    raise on a CUDA error, else count the launch."""
    lib = build()
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        msg = lib.gemm_error_string(rc).decode()
        raise RuntimeError(f"{entry}: {fn} launch failed with CUDA error {rc} ({msg})")
    LAUNCHES[entry] += 1
