"""AST architecture lint over ``src/repro_torch`` (rules RCCA001-RCCA007).

Port of ``repro/analysis/lint.py``, its scopes retargeted to the port.
The bitwise-reproducibility contract (Local ≡ Sharded ≡ Cluster ≡
Hybrid, store ≡ in memory, resume ≡ uninterrupted, delta ≡ cold) holds
only while a handful of disciplines do.  Each rule pins one:

  RCCA001  accumulator-fold loops live in ``repro_torch/exec`` only.  A
           loop elsewhere that calls the fold/merge primitives
           (``merge_stats``, ``push_group``, ``end_chunk``,
           ``flush_tail``, ``reduce_group_partials``, or an
           ``*update_fn``) reimplements the accumulation order that the
           canonical pairwise tree owns.
  RCCA002  the toolchain and foreign-function surface (``ctypes``, the
           ``nvcc`` compiler, ``torch.utils.cpp_extension``) is touched
           only in :mod:`repro_torch.kernels.build`, which builds, loads
           and binds every kernel; and no module imports ``jax`` or the
           JAX package ``repro`` (the port stands alone).  The
           reference's rule pins jax's version-sensitive APIs to its
           compat shim; the port has no jax, and its counterpart is the
           one place where C meets Python.
  RCCA003  view-store shard files (``shard_*.a.npy`` / ``*.b.npy``) are
           read only by ``repro_torch/store``: a direct read bypasses the
           manifest (fingerprint, row ranges, dtype) and the store's
           atomic publish.
  RCCA004  pass-path modules (``repro_torch/exec``,
           ``repro_torch/cluster``, ``repro_torch/core/rcca.py``,
           ``repro_torch/store/passes.py``) are deterministic: no wall
           clock (``time.time``), no ``uuid``, no legacy global RNG
           (``random.*`` / ``np.random.*`` module-level calls), no
           iteration over ``set()``: set order is a hash-seed coin flip
           and merge-group order is part of the contract.
  RCCA005  cluster and store file writes go through the atomic staging
           and rename helpers (``repro_torch.ckpt.save_pytree``, the
           store writer's staging directory): no bare ``open(.., "w")``
           or ``np.save`` outside them.  A torn write a reader can see is
           a protocol violation.
  RCCA006  torch RNG draws in the pass path happen only in
           ``repro_torch/core/rcca.py`` (``init_Q`` / ``draw_omega``):
           ``torch.Generator``, ``torch.randn`` / ``rand`` / ``randint`` /
           ``normal``, ``torch.manual_seed`` anywhere else in the pass
           path is a second entropy source that the seeded-Ω contract
           cannot see (the reference's rule names ``jax.random``).
  RCCA007  pass-path modules (and ``repro_torch/store/prefetch.py``) take
           their timings from the :mod:`repro_torch.obs` clocks
           (``obs.monotonic()`` / ``obs.wall()``), not raw
           ``time.monotonic`` / ``time.perf_counter``: one clock keeps
           spans, IO counters and diagnostics comparable.

Suppression: a trailing ``# rcca: noqa`` comment silences every rule on
that line; ``# rcca: noqa[RCCA004]`` (codes comma-separated) only those.
Every suppression carries a justification: the lint is the contract's
memory, a noqa its documented exception.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable, List, Optional, Sequence

from .report import Violation

# ---------------------------------------------------------------------------
# rule scoping
# ---------------------------------------------------------------------------

#: the package the lint walks
PACKAGE = "repro_torch"

#: modules allowed to hold accumulator-fold loops (RCCA001)
FOLD_HOME = ("repro_torch/exec/",)

#: the one module that builds, loads and binds the kernels (RCCA002)
TOOLCHAIN_HOME = ("repro_torch/kernels/build.py",)

#: modules allowed to read store shard files directly (RCCA003)
STORE_HOME = ("repro_torch/store/",)

#: deterministic pass-path modules (RCCA004)
PASS_PATH = ("repro_torch/exec/", "repro_torch/cluster/", "repro_torch/core/rcca.py",
             "repro_torch/store/passes.py")

#: modules whose file writes must be staged and renamed (RCCA005);
#: ``repro_torch/ckpt`` is the atomic helper itself and is out of scope
ATOMIC_WRITE_SCOPE = ("repro_torch/cluster/", "repro_torch/store/")

#: the one pass-path module allowed to draw from the torch RNG (RCCA006)
RNG_HOME = ("repro_torch/core/rcca.py",)

#: modules whose timings must come from the repro_torch.obs clocks (RCCA007)
OBS_CLOCK_SCOPE = PASS_PATH + ("repro_torch/store/prefetch.py",)

#: the package that implements the obs clocks (out of RCCA007's scope)
OBS_HOME = ("repro_torch/obs/",)

#: fold/merge primitives whose looped use outside repro_torch/exec trips RCCA001
FOLD_CALLS = frozenset({
    "merge_stats", "merge_power_stats", "merge_final_stats",
    "push_group", "end_chunk", "flush_tail", "reduce_group_partials",
})
FOLD_FN_RE = re.compile(r"^(jit_)?update_fn$")

#: the foreign-function and toolchain modules (RCCA002), prefix match on
#: the import path
TOOLCHAIN_MODULES = ("ctypes", "torch.utils.cpp_extension")
#: packages the port must not import (RCCA002): jax and the JAX package
FOREIGN_PACKAGES = ("jax", "jaxlib", "repro")
#: a string that names the CUDA compiler (RCCA002)
NVCC_RE = re.compile(r"(^|[/\\])nvcc(\.exe)?$")

#: view-store shard data-file naming (RCCA003)
SHARD_FILE_RE = re.compile(r"\.(a|b)\.npy\b")

NOQA_RE = re.compile(r"#\s*rcca:\s*noqa(?:\[([A-Za-z0-9,\s]+)\])?")


def _in(relpath: str, prefixes: Sequence[str]) -> bool:
    return any(relpath == p or relpath.startswith(p) for p in prefixes)


# ---------------------------------------------------------------------------
# per-rule AST visitors
# ---------------------------------------------------------------------------


def _call_name(node: ast.Call) -> Optional[str]:
    """Trailing identifier of the callee: ``f(...)`` → f, ``o.m(...)`` → m."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` attribute chain as a dotted string, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


_LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.comprehension)


def _rule_001(tree: ast.AST, relpath: str) -> Iterable[Violation]:
    if _in(relpath, FOLD_HOME):
        return
    # collect line spans of loop bodies, then flag fold calls inside them
    loop_nodes: List[ast.AST] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            loop_nodes.append(node)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            loop_nodes.append(node)
    seen = set()
    for loop in loop_nodes:
        for node in ast.walk(loop):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name is None:
                continue
            if name in FOLD_CALLS or FOLD_FN_RE.match(name):
                key = (node.lineno, name)
                if key in seen:
                    continue
                seen.add(key)
                yield Violation(
                    "RCCA001", relpath, node.lineno,
                    f"accumulator-fold call `{name}` in a loop outside "
                    "repro_torch/exec — fold order is owned by the canonical "
                    "pairwise tree (repro_torch.exec.accumulate)")


def _imports(tree: ast.AST) -> Iterable[tuple]:
    """(line, dotted module path) of every import; ``from m import a``
    gives ``m.a`` (``m`` alone for a relative import's package)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: inside the package itself
                continue
            mod = node.module or ""
            for alias in node.names:
                yield node.lineno, f"{mod}.{alias.name}" if mod else alias.name


def _under(dotted: str, prefixes: Sequence[str]) -> bool:
    return any(dotted == p or dotted.startswith(p + ".") for p in prefixes)


def _rule_002(tree: ast.AST, relpath: str) -> Iterable[Violation]:
    for line, name in _imports(tree):
        if _under(name, FOREIGN_PACKAGES):
            yield Violation(
                "RCCA002", relpath, line,
                f"import of `{name}` — the port imports neither jax nor the JAX "
                "package repro; keep a copy of what it needs")
    if _in(relpath, TOOLCHAIN_HOME):
        return
    docstrings = _docstring_nodes(tree)
    for line, name in _imports(tree):
        if _under(name, TOOLCHAIN_MODULES):
            yield Violation(
                "RCCA002", relpath, line,
                f"toolchain/foreign-function import `{name}` outside "
                "repro_torch.kernels.build — build, load and bind kernels there")
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            dotted = _dotted(node)
            if dotted and (dotted.startswith("torch.utils.cpp_extension.")
                           or dotted.startswith("ctypes.")):
                yield Violation(
                    "RCCA002", relpath, node.lineno,
                    f"toolchain/foreign-function use `{dotted}` outside "
                    "repro_torch.kernels.build — build, load and bind kernels there")
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and id(node) not in docstrings and NVCC_RE.search(node.value)):
            yield Violation(
                "RCCA002", relpath, node.lineno,
                f"the CUDA compiler `{node.value}` named outside "
                "repro_torch.kernels.build — compile through kernels.build")


def _docstring_nodes(tree: ast.AST) -> set:
    """ids of string constants that are docstrings (documentation may
    legitimately name shard files; code must not)."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                out.add(id(body[0].value))
    return out


def _rule_003(tree: ast.AST, relpath: str) -> Iterable[Violation]:
    if _in(relpath, STORE_HOME):
        return
    docstrings = _docstring_nodes(tree)
    # constants embedded in an f-string are reported via the JoinedStr,
    # not double-reported on their own
    embedded = {id(v) for node in ast.walk(tree)
                if isinstance(node, ast.JoinedStr) for v in node.values}
    for node in ast.walk(tree):
        if id(node) in docstrings or id(node) in embedded:
            continue
        text = None
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            text = node.value
        elif isinstance(node, ast.JoinedStr):
            text = "".join(v.value for v in node.values
                           if isinstance(v, ast.Constant)
                           and isinstance(v.value, str))
        if text and SHARD_FILE_RE.search(text):
            yield Violation(
                "RCCA003", relpath, node.lineno,
                "store shard data file referenced outside repro_torch/store — "
                "read views through ViewStoreReader (manifest-checked, "
                "atomic-publish aware)")


#: module-level legacy RNG entry points (unseeded global state)
_RNG_CALLS = frozenset({
    "random.random", "random.randint", "random.randrange", "random.choice",
    "random.shuffle", "random.sample", "random.uniform",
    "np.random.rand", "np.random.randn", "np.random.randint",
    "np.random.random", "np.random.permutation", "np.random.shuffle",
    "np.random.choice", "numpy.random.rand", "numpy.random.randn",
    "numpy.random.randint", "numpy.random.random",
})
_CLOCK_CALLS = frozenset({"time.time", "time.time_ns"})


def _rule_004(tree: ast.AST, relpath: str) -> Iterable[Violation]:
    if not _in(relpath, PASS_PATH):
        return
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func)
            if dotted in _CLOCK_CALLS:
                yield Violation(
                    "RCCA004", relpath, node.lineno,
                    f"wall-clock `{dotted}()` in a pass-path module — "
                    "pass results must not depend on when they ran")
            elif dotted in _RNG_CALLS:
                yield Violation(
                    "RCCA004", relpath, node.lineno,
                    f"unseeded global RNG `{dotted}()` in a pass-path "
                    "module — thread a seeded Generator")
            elif dotted and (dotted == "uuid.uuid4"
                             or dotted.startswith("uuid.uuid")):
                yield Violation(
                    "RCCA004", relpath, node.lineno,
                    f"`{dotted}()` in a pass-path module — identifiers in "
                    "the pass path must be derived, not random")
        if isinstance(node, (ast.For, ast.AsyncFor)):
            it = node.iter
            is_set = (isinstance(it, ast.Call)
                      and isinstance(it.func, ast.Name)
                      and it.func.id in ("set", "frozenset")) \
                or isinstance(it, ast.Set)
            if is_set:
                yield Violation(
                    "RCCA004", relpath, node.lineno,
                    "iteration over a set in a pass-path module — set "
                    "order is hash-seed dependent; use dict.fromkeys or "
                    "sorted() for a deterministic order")
        if isinstance(node, ast.comprehension):
            it = node.iter
            if (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                    and it.func.id in ("set", "frozenset")):
                yield Violation(
                    "RCCA004", relpath, it.lineno,
                    "comprehension over a set in a pass-path module — set "
                    "order is hash-seed dependent; use dict.fromkeys or "
                    "sorted() for a deterministic order")


_SAVE_CALLS = frozenset({"np.save", "np.savez", "np.savez_compressed",
                         "numpy.save", "numpy.savez",
                         "numpy.savez_compressed"})


def _rule_005(tree: ast.AST, relpath: str) -> Iterable[Violation]:
    if not _in(relpath, ATOMIC_WRITE_SCOPE):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if dotted in _SAVE_CALLS:
            yield Violation(
                "RCCA005", relpath, node.lineno,
                f"`{dotted}` in cluster/store scope — write through an "
                "atomic staging+rename helper (repro_torch.ckpt.save_pytree / "
                "the store writer's staging dir)")
            continue
        callee = _call_name(node)
        if callee != "open":
            continue
        mode = None
        if len(node.args) >= 2:
            a = node.args[1]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                mode = a.value
        for kw in node.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                mode = kw.value.value
        if mode and mode[0] in ("w", "x"):
            yield Violation(
                "RCCA005", relpath, node.lineno,
                f"direct `open(.., {mode!r})` in cluster/store scope — "
                "publish through atomic staging+rename so readers never "
                "observe a torn file (appends are exempt)")


#: torch RNG entry points (RCCA006): a draw or a fresh entropy source
_TORCH_RNG = frozenset({
    "torch.Generator", "torch.randn", "torch.rand", "torch.randint", "torch.normal",
    "torch.manual_seed", "torch.randn_like", "torch.rand_like", "torch.randint_like",
    "torch.randperm", "torch.bernoulli", "torch.multinomial", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.seed", "torch.cuda.seed",
})


def _rule_006(tree: ast.AST, relpath: str) -> Iterable[Violation]:
    if not _in(relpath, PASS_PATH) or _in(relpath, RNG_HOME):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if dotted in _TORCH_RNG:
            yield Violation(
                "RCCA006", relpath, node.lineno,
                f"`{dotted}()` in a pass-path module outside rcca.py — "
                "Ω and its seeds come from repro_torch.core.rcca (init_Q / "
                "omega_seeds); a second draw site breaks the seeded-Ω "
                "equivalence across engines and topologies")


_MONO_CALLS = frozenset({"time.monotonic", "time.monotonic_ns",
                         "time.perf_counter", "time.perf_counter_ns"})


def _rule_007(tree: ast.AST, relpath: str) -> Iterable[Violation]:
    if not _in(relpath, OBS_CLOCK_SCOPE) or _in(relpath, OBS_HOME):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if dotted in _MONO_CALLS:
            yield Violation(
                "RCCA007", relpath, node.lineno,
                f"raw clock `{dotted}()` in pass-path scope — take "
                "timings via repro_torch.obs (obs.monotonic() / obs.wall()) so "
                "spans, io counters, and diagnostics share one clock "
                "domain")


_RULES = (_rule_001, _rule_002, _rule_003, _rule_004, _rule_005, _rule_006,
          _rule_007)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def _noqa_codes(line: str) -> Optional[frozenset]:
    """Suppressed codes on this source line: ``frozenset()`` means ALL
    rules (bare noqa), ``None`` means no suppression."""
    m = NOQA_RE.search(line)
    if not m:
        return None
    if not m.group(1):
        return frozenset()
    return frozenset(c.strip().upper() for c in m.group(1).split(","))


def lint_source(src: str, relpath: str) -> List[Violation]:
    """Lint one module's source.  ``relpath`` is the path relative to
    the ``src/`` root (e.g. ``repro_torch/cluster/worker.py``) — rule scoping
    keys off it, which is also what makes fixture snippets testable
    under any synthetic path."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Violation("RCCA000", relpath, e.lineno or 0,
                          f"unparsable module: {e.msg}")]
    lines = src.splitlines()
    out: List[Violation] = []
    for rule in _RULES:
        for v in rule(tree, relpath):
            line = lines[v.line - 1] if 0 < v.line <= len(lines) else ""
            codes = _noqa_codes(line)
            if codes is not None and (not codes or v.code in codes):
                continue
            out.append(v)
    return out


def lint_file(path: str, src_root: str) -> List[Violation]:
    relpath = os.path.relpath(path, src_root).replace(os.sep, "/")
    with open(path) as f:
        return lint_source(f.read(), relpath)


def lint_tree(src_root: Optional[str] = None) -> List[Violation]:
    """Lint every ``repro_torch`` module under ``src_root`` (default: the
    source root this package was imported from)."""
    if src_root is None:
        src_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    out: List[Violation] = []
    pkg_root = os.path.join(src_root, PACKAGE)
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames.sort()
        for fname in sorted(filenames):
            if fname.endswith(".py"):
                out.extend(lint_file(os.path.join(dirpath, fname), src_root))
    return out
