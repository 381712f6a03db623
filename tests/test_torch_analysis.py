"""repro_torch.analysis: the architecture lint (a must-trip and a must-pass
fixture per rule, the same codes as the reference's lint on the same
source), the kernel contract checker (the registry clean on the CPU, a
mutated plan tripping each rule), the command line, and the determinism
sanitizer (the reference's digests and comparator on the same numpy
states, sanitized fits on the CPU: reproducible, a two-worker cluster
fit's trace the Local fit's, two fits on two threads apart).

The protocol half lives in tests/test_torch_analysis_protocol.py.
"""

import dataclasses
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro.analysis import lint as jlint
from repro.analysis import sanitize as jsanitize
from repro_torch.analysis import kernel_check, lint, sanitize
from repro_torch.analysis.__main__ import main as analyze
from repro_torch.analysis.report import Violation, render_report
from repro_torch.core import rcca as tr
from repro_torch.data import PlantedCCAData
from repro_torch.exec import Cluster, fit
from repro_torch.kernels import KERNEL_REGISTRY, KernelDef, matmul, plan
from repro_torch.store import ingest_planted


def codes(violations):
    return sorted(v.code for v in violations)


def lint_src(src, relpath):
    return lint.lint_source(textwrap.dedent(src), relpath)


# ---------------------------------------------------------------------------
# architecture lint: one must-trip and one must-pass fixture per rule
# ---------------------------------------------------------------------------


def test_lint_unparsable_is_rcca000():
    assert codes(lint_src("def broken(:\n", "repro_torch/x.py")) == ["RCCA000"]


def test_rcca001_fold_loop_outside_exec_trips():
    src = """
    def merge_all(partials, acc):
        for p in partials:
            acc = merge_stats(acc, p)
        return acc
    """
    vs = lint_src(src, "repro_torch/cluster/bad.py")
    assert codes(vs) == ["RCCA001"]
    assert "pairwise tree" in vs[0].message


def test_rcca001_comprehension_and_update_fn_trip():
    src = """
    def f(groups, acc):
        [acc.push_group(g, s) for g, s in groups]
        while groups:
            acc2 = jit_update_fn(acc, *groups.pop())
    """
    assert codes(lint_src(src, "repro_torch/core/bad.py")) == ["RCCA001", "RCCA001"]


def test_rcca001_inside_exec_and_unlooped_pass():
    src = """
    def merge_all(partials, acc):
        for p in partials:
            acc = merge_stats(acc, p)
        return acc
    """
    assert lint_src(src, "repro_torch/exec/accumulate.py") == []
    # one straight-line fold call is delegation, not a reimplementation
    assert lint_src("def f(acc, s):\n    acc.push_group(0, s)\n",
                    "repro_torch/cluster/ok.py") == []


@pytest.mark.parametrize("src", [
    "import ctypes\n",
    "from ctypes import CDLL\n",
    "from torch.utils.cpp_extension import load\n",
    "import torch\ndef f():\n    return torch.utils.cpp_extension.load('k', ['k.cu'])\n",
    "import subprocess\ndef f(src):\n    subprocess.run(['nvcc', '-c', src])\n",
    "def f():\n    return '/usr/local/cuda/bin/nvcc'\n",
    "import jax.numpy as jnp\n",
    "from repro.core import rcca\n",
    "import repro.kernels.rand\n",
], ids=["ctypes", "ctypes-from", "cpp_extension", "cpp_extension-attr", "nvcc",
        "nvcc-path", "jax", "repro-from", "repro-import"])
def test_rcca002_toolchain_and_foreign_imports_trip(src):
    vs = lint_src(src, "repro_torch/exec/bad.py")
    assert codes(vs) and set(codes(vs)) == {"RCCA002"}, src


def test_rcca002_build_home_and_port_imports_pass():
    src = "import ctypes\nimport subprocess\ndef f(s):\n    subprocess.run(['nvcc', s])\n"
    assert lint_src(src, "repro_torch/kernels/build.py") == []
    ok = '''"""Compiled by nvcc at first use."""
from repro_torch.kernels import build
from . import plan
from ..obs import span
import torch.cuda
'''
    assert lint_src(ok, "repro_torch/exec/ok.py") == []
    # jax stays foreign even in the build module
    assert codes(lint_src("import jax\n", "repro_torch/kernels/build.py")) == ["RCCA002"]


def test_rcca003_shard_file_reference_trips_outside_store():
    src = "def f(d, i):\n    return load(f'{d}/shard_{i:05d}.a.npy')\n"
    assert codes(lint_src(src, "repro_torch/cluster/bad.py")) == ["RCCA003"]
    assert lint_src(src, "repro_torch/store/format.py") == []
    doc = '"""Reads shard_00000.a.npy via the manifest."""\n'
    assert lint_src(doc, "repro_torch/cluster/ok.py") == []


def test_rcca004_nondeterminism_in_pass_path_trips():
    src = """
    def f(groups):
        t = time.time()
        fit = uuid.uuid4()
        x = np.random.randn(3)
        for g in set(groups):
            pass
        return [g for g in set(groups)]
    """
    assert codes(lint_src(src, "repro_torch/exec/bad.py")) == ["RCCA004"] * 5


def test_rcca004_outside_pass_path_and_deterministic_iter_pass():
    src = "def f():\n    return time.time(), np.random.randn(3)\n"
    assert lint_src(src, "repro_torch/launch/cca_fit.py") == []
    src = """
    def f(groups):
        for g in sorted(set(groups)):
            pass
        for g in dict.fromkeys(groups):
            pass
    """
    assert lint_src(src, "repro_torch/exec/ok.py") == []


def test_rcca005_bare_writes_trip_and_appends_pass():
    src = """
    def publish(path, obj, arr):
        with open(path, "w") as f:
            f.write(obj)
        np.save(path + ".npy", arr)
    """
    assert codes(lint_src(src, "repro_torch/cluster/bad.py")) == ["RCCA005", "RCCA005"]
    src = """
    def f(path):
        with open(path) as f:
            f.read()
        with open(path, "a") as f:
            f.write("x")
    """
    assert lint_src(src, "repro_torch/store/ok.py") == []
    assert lint_src("def f(p, a):\n    np.save(p, a)\n", "repro_torch/launch/x.py") == []


def test_rcca006_torch_rng_in_pass_path_trips():
    src = """
    def f(d, k):
        g = torch.Generator(device="cpu")
        torch.manual_seed(0)
        return torch.randn((d, k), generator=g), torch.rand(3), torch.randint(0, 9, (2,))
    """
    assert codes(lint_src(src, "repro_torch/exec/bad.py")) == ["RCCA006"] * 5
    assert codes(lint_src(src, "repro_torch/store/passes.py")) == ["RCCA006"] * 5


def test_rcca006_rng_home_and_other_scopes_pass():
    src = "def f(d, k):\n    g = torch.Generator()\n    return torch.randn((d, k), generator=g)\n"
    assert lint_src(src, "repro_torch/core/rcca.py") == []
    assert lint_src(src, "repro_torch/data/synthetic.py") == []


def test_rcca007_raw_clocks_trip_and_obs_clocks_pass():
    src = """
    def f():
        t0 = time.perf_counter()
        t1 = time.monotonic()
        t2 = time.monotonic_ns()
        return time.perf_counter_ns() - t0
    """
    for relpath in ("repro_torch/exec/bad.py", "repro_torch/store/prefetch.py"):
        assert codes(lint_src(src, relpath)) == ["RCCA007"] * 4
    ok = "def f():\n    t0 = obs.monotonic()\n    return obs.monotonic() - t0, obs.wall()\n"
    assert lint_src(ok, "repro_torch/exec/ok.py") == []
    raw = "def f():\n    return time.perf_counter()\n"
    assert lint_src(raw, "repro_torch/launch/cca_fit.py") == []
    assert lint_src(raw, "repro_torch/obs/trace.py") == []


def test_noqa_suppression_bare_and_coded():
    trip = "def f(p, a):\n    np.save(p, a)\n"
    assert codes(lint_src(trip, "repro_torch/cluster/x.py")) == ["RCCA005"]
    for tail in ("  # rcca: noqa", "  # rcca: noqa[RCCA005]", "  # rcca: noqa[RCCA001, RCCA005]"):
        src = trip.replace("np.save(p, a)", "np.save(p, a)" + tail)
        assert lint_src(src, "repro_torch/cluster/x.py") == [], tail
    src = trip.replace("np.save(p, a)", "np.save(p, a)  # rcca: noqa[RCCA001]")
    assert codes(lint_src(src, "repro_torch/cluster/x.py")) == ["RCCA005"]


def test_lint_tree_is_clean():
    """The port's own tree: no unsuppressed violation, and every
    suppression names its codes."""
    assert lint.lint_tree() == []


# the reference's fixtures per rule, linted by both packages at their own paths
SHARED_FIXTURES = {
    "RCCA001": ("cluster/bad.py", "def f(ps, acc):\n    for p in ps:\n"
                                  "        acc = merge_stats(acc, p)\n"),
    "RCCA003": ("cluster/bad.py", "def f(d, i):\n    return load(f'{d}/shard_{i:05d}.a.npy')\n"),
    "RCCA004": ("exec/bad.py", "def f(gs):\n    t = time.time()\n    u = uuid.uuid4()\n"
                               "    x = np.random.randn(3)\n    for g in set(gs):\n"
                               "        pass\n"),
    "RCCA005": ("store/bad.py", "def f(p, o, a):\n    with open(p, 'w') as f:\n"
                                "        f.write(o)\n    np.save(p, a)\n"),
    "RCCA007": ("store/prefetch.py", "def f():\n    t0 = time.perf_counter()\n"
                                     "    return time.monotonic() - t0\n"),
}


@pytest.mark.parametrize("rule", sorted(SHARED_FIXTURES))
def test_lint_codes_match_reference(rule):
    rel, src = SHARED_FIXTURES[rule]
    got = lint.lint_source(src, f"repro_torch/{rel}")
    want = jlint.lint_source(src, f"repro/{rel}")
    assert codes(got) == codes(want) and set(codes(got)) == {rule}
    assert [v.line for v in got] == [v.line for v in want]
    # and both pass the same code at a path outside the rule's scope
    free = {"RCCA001": "exec/x.py", "RCCA003": "store/x.py"}.get(rule, "launch/x.py")
    assert lint.lint_source(src, f"repro_torch/{free}") == []
    assert jlint.lint_source(src, f"repro/{free}") == []


# ---------------------------------------------------------------------------
# kernel contract checker
# ---------------------------------------------------------------------------


def _nn(M=300, N=200, K=100):
    return plan.gemm_nn(M, N, K)


def test_check_plan_real_plans_are_clean():
    plans = (_nn(), plan.gemm_tn(2060, 2060, 8192), plan.omega_fill(300, 70, plan.BF16),
             *plan.plan_project_rows(3, 2500, 7), *plan.plan_projgram(130, 300, 1100),
             *plan.plan_power_project_accumulate(256, 4096, 256, 512, dtype=plan.BF16))
    for p in plans:
        assert kernel_check.check_plan(p) == [], p.kernel


def test_registry_covers_every_form():
    forms = {(e, d) for e, rows in matmul.FORMS.items() for d in rows}
    assert {(k.entry, k.dtypes) for k in KERNEL_REGISTRY.values()} == forms
    assert len(KERNEL_REGISTRY) == 24
    assert all(k.probes and k.path for k in KERNEL_REGISTRY.values())


def test_registry_is_clean_on_the_cpu():
    """Every form's plans at the small probes and the main path's shapes,
    and its entry point's results (plain versions) at the small probes."""
    assert kernel_check.check_registry(device="cpu") == []


@pytest.mark.parametrize("code,mutate", [
    ("RCCA101", lambda p: dataclasses.replace(p, grid=(p.grid[0] + 1, p.grid[1]))),
    ("RCCA101", lambda p: dataclasses.replace(p, grid=(0, p.grid[1]))),
    ("RCCA102", lambda p: dataclasses.replace(p, ins=((None, p.out[1] - 200), p.ins[1]))),
    ("RCCA103", lambda p: dataclasses.replace(p, grid=(p.grid[0], p.grid[1] - 1))),
    ("RCCA104", lambda p: dataclasses.replace(p, block=(2048,))),
    ("RCCA104", lambda p: dataclasses.replace(p, smem_bytes=kernel_check.SMEM_OPT_IN + 1)),
    ("RCCA105", lambda p: dataclasses.replace(p, out_dtype="bfloat16")),
], ids=["surplus", "empty", "operand", "uncovered", "threads", "smem", "bf16-out"])
def test_mutated_plan_trips(code, mutate):
    got = codes(kernel_check.check_plan(mutate(_nn())))
    # a surplus column of blocks also reads past its operand
    assert got == ([code, "RCCA102"] if mutate(_nn()).grid[0] > _nn().grid[0] else [code])


def test_persistent_grid_rules():
    (fused,) = plan.plan_projgram(8192, 2 ** 19, 970)
    assert fused.persistent and kernel_check.check_plan(fused) == []
    too_many = dataclasses.replace(fused, out=(128, 128), grid=(2,))
    # two blocks for one tile; X's rows and Q's columns outside its tile space
    assert codes(kernel_check.check_plan(too_many)) == ["RCCA101", "RCCA102", "RCCA102"]
    resident = plan.F32_TILES[plan.FUSED_F32_TILE][3] * plan.SMS
    wide = dataclasses.replace(fused, grid=(resident + 1,))
    assert codes(kernel_check.check_plan(wide)) == ["RCCA104"]
    bf16_in = dataclasses.replace(fused, dtypes=("bfloat16", "bfloat16"), out_dtype="bfloat16")
    assert codes(kernel_check.check_plan(bf16_in)) == ["RCCA105", "RCCA105"]


def _kdef(name, **kw):
    return dataclasses.replace(KERNEL_REGISTRY[name], **kw)


def test_rcca106_results_must_match_the_plan():
    bad = _kdef("proj_stage", outputs=lambda p: (((p["n"], p["kt"] + 1), torch.float32),))
    vs = kernel_check.check_kernel(bad, device="cpu")
    assert vs and set(codes(vs)) == {"RCCA106"}
    two = _kdef("matmul_tn", outputs=lambda p: (((p["M"], p["N"]), torch.float32),) * 2)
    assert set(codes(kernel_check.check_kernel(two, device="cpu"))) == {"RCCA106"}
    crash = _kdef("gram_sweep", call=lambda p, dev: 1 / 0)
    assert "ZeroDivisionError" in kernel_check.check_kernel(crash, device="cpu")[0].message


def test_rcca106_catches_the_old_omega_fill_name():
    """The f32 generator's plan named its launch ``omega_fill`` while
    ``FORMS`` and ``build`` call the C function ``omega_fill_f32``."""
    def old_name(p):
        return tuple(dataclasses.replace(q, kernel="omega_fill")
                     if q.kernel == "omega_fill_f32" else q for q in KERNEL_REGISTRY[
                         "proj_stage_seeded"].plan(p))
    for name, kdef in (("omega_fill", _kdef("omega_fill", plan=lambda p: (
            dataclasses.replace(plan.omega_fill(p["rows"], p["kt"]), kernel="omega_fill"),))),
                       ("proj_stage_seeded", _kdef("proj_stage_seeded", plan=old_name))):
        vs = kernel_check.check_kernel(kdef, run=False)
        assert codes(vs) == ["RCCA106"] * len(kdef.probes), name
        assert "'omega_fill'" in vs[0].message


def test_rcca106_form_must_name_a_bound_c_function(monkeypatch):
    f32 = (torch.float32, torch.float32)
    monkeypatch.setitem(matmul.FORMS["matmul_nn"], f32, "gemm_nn_f32_unbound")
    vs = kernel_check.check_kernel(KERNEL_REGISTRY["matmul_nn"], run=False)
    assert set(codes(vs)) == {"RCCA106"}
    assert any("does not bind" in v.message for v in vs)


def test_rcca108_seed_rules():
    seeded = KERNEL_REGISTRY["proj_stage_seeded"]
    no_seed = _kdef("proj_stage_seeded", plan=lambda p: tuple(
        dataclasses.replace(q, seeds=0) for q in seeded.plan(p)))
    three = _kdef("proj_stage_seeded", plan=lambda p: tuple(
        dataclasses.replace(q, seeds=3 if q.seeds else 0) for q in seeded.plan(p)))
    on_gemm = _kdef("proj_stage", plan=lambda p: tuple(
        dataclasses.replace(q, seeds=2) for q in KERNEL_REGISTRY["proj_stage"].plan(p)))
    for kdef in (no_seed, three, on_gemm):
        vs = kernel_check.check_kernel(kdef, run=False)
        assert vs and set(codes(vs)) == {"RCCA108"}, kdef.name


def test_check_kernel_rejects_an_inconsistent_registered_plan():
    bad = KernelDef(name="bad_fixture", entry="matmul_nn", dtypes=(torch.float32,) * 2,
                    plan=lambda p: (dataclasses.replace(_nn(), grid=(1, 1)),),
                    outputs=lambda p: (), call=lambda p, dev: (), probes=({"M": 300},))
    assert codes(kernel_check.check_kernel(bad, run=False)) == ["RCCA103", "RCCA103"]
    raises = dataclasses.replace(bad, plan=lambda p: plan.gemm_nn(1, 1, 1, dtype=torch.float16))
    assert codes(kernel_check.check_kernel(raises, run=False)) == ["RCCA101"]


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_cli_gates_exit_zero_on_the_cpu(capsys):
    assert analyze(["lint"]) == 0
    assert analyze(["protocol"]) == 0
    assert analyze(["kernels", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "5 crash scenarios, 42 interleavings" in out
    assert "RCCA107 not run" in out
    assert out.count("-> clean") == 3


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the host without CUDA")
def test_kernels_cli_raises_without_cuda():
    with pytest.raises(RuntimeError, match="--device cpu"):
        analyze(["kernels"])


def test_lint_cli_on_paths(tmp_path, capsys):
    bad = tmp_path / "src" / "repro_torch" / "exec" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import time\ndef f():\n    return time.perf_counter()\n")
    assert analyze(["lint", str(bad)]) == 1
    assert "repro_torch/exec/bad.py:3: RCCA007" in capsys.readouterr().out


def test_render_report_sorts_and_counts():
    vs = [Violation("RCCA005", "b.py", 9, "later"), Violation("RCCA001", "a.py", 2, "earlier")]
    text = render_report(vs, title="lint")
    assert text.index("a.py:2") < text.index("b.py:9")
    assert "-> 2 violations" in text
    assert "-> clean" in render_report([], title="lint")


# ---------------------------------------------------------------------------
# determinism sanitizer (RCCA301)
# ---------------------------------------------------------------------------


@pytest.fixture
def sanitizing(monkeypatch):
    monkeypatch.setenv("RCCA_SANITIZE", "1")
    sanitize.reset()
    yield
    sanitize.reset()


def test_observe_is_a_noop_when_disabled(monkeypatch):
    monkeypatch.delenv("RCCA_SANITIZE", raising=False)
    sanitize.reset()
    sanitize.observe("group:0", {"y": np.ones(3, np.float32)})
    assert sanitize.snapshot() == []
    with sanitize.override(True):
        sanitize.observe("group:0", {"y": np.ones(3, np.float32)})
    assert len(sanitize.snapshot()) == 1


def test_digests_match_the_reference():
    """The same numpy state digests the same in both packages: a dict, the
    stats NamedTuples (torch tensors here, jax arrays there), bf16."""
    import jax.numpy as jnp

    from repro.core import rcca as jr

    rng = np.random.default_rng(3)
    y = rng.standard_normal((5, 3)).astype(np.float32)
    n = np.float32(7)
    tree = {"y": y, "n": n, "z": [y[:2], (y[0], n)]}
    assert sanitize.digest(tree) == _jdigest(tree)
    fields = [rng.standard_normal(s).astype(np.float32)
              for s in ((6, 4), (5, 4), (6,), (5,), (), (), ())]
    t = tr.PowerStats(*(torch.from_numpy(f) for f in fields))
    j = jr.PowerStats(*(jnp.asarray(f) for f in fields))
    assert sanitize.digest(t) == _jdigest(j)
    b = torch.from_numpy(y).to(torch.bfloat16)
    assert sanitize.digest({"b": b}) == _jdigest({"b": jnp.asarray(y).astype(jnp.bfloat16)})
    assert sanitize.digest({"b": b}) != sanitize.digest({"b": b.float()})


def _jdigest(tree):
    jsanitize.reset()
    prev = jsanitize.os.environ.get("RCCA_SANITIZE")
    jsanitize.os.environ["RCCA_SANITIZE"] = "1"
    try:
        jsanitize.observe("x", tree)
        return jsanitize.snapshot()[0]["digest"]
    finally:
        if prev is None:
            jsanitize.os.environ.pop("RCCA_SANITIZE")
        else:
            jsanitize.os.environ["RCCA_SANITIZE"] = prev
        jsanitize.reset()


def test_first_divergence_pinpoints_a_bit_flip_as_the_reference(sanitizing):
    good = np.arange(8, dtype=np.float32)
    bad = good.copy()
    bad[5] = np.nextafter(bad[5], np.inf)  # one ulp: invisible to allclose
    traces = []
    for flip in (False, True):
        sanitize.reset()
        sanitize.set_context(pass_idx=1, kind="power")
        for g in range(3):
            sanitize.observe(f"group:{g}", {"y": bad if flip and g == 2 else good})
        traces.append(sanitize.snapshot())
    d = sanitize.first_divergence(*traces)
    assert d["code"] == "RCCA301" and d["reason"] == "digest"
    assert d["index"] == 2 and d["a"]["label"] == "group:2"
    assert d == jsanitize.first_divergence(*traces)
    relabeled = [dict(r, label="group:9") for r in traces[1]]
    assert sanitize.first_divergence(traces[0], relabeled)["reason"] == "label"
    assert sanitize.first_divergence(traces[0], traces[0] + traces[1])["reason"] == "length"
    for a, b in ((traces[0], relabeled), (traces[0], traces[0] + traces[1])):
        assert sanitize.first_divergence(a, b) == jsanitize.first_divergence(a, b)
    sited = [dict(r, site="mesh") for r in traces[0]]
    assert sanitize.first_divergence(traces[0], sited)["reason"] == "label"
    assert sanitize.first_divergence(traces[0], sited, ignore=("site",)) is None


def test_dump_load_and_the_diff_cli(sanitizing, tmp_path, capsys):
    sanitize.set_context(pass_idx=0, kind="final", site="stream")
    sanitize.observe("pass_end", {"y": np.zeros(2, np.float32)})
    out = str(tmp_path / "a.json")
    assert sanitize.dump(out) == out
    assert sanitize.load(out) == sanitize.snapshot()
    sanitize.observe("pass_end", {"y": np.ones(2, np.float32)})
    other = sanitize.dump(str(tmp_path / "b.json"))
    assert analyze(["sanitize-diff", out, out]) == 0
    assert analyze(["sanitize-diff", out, other]) == 1
    assert "(length)" in capsys.readouterr().out


N, DA, DB, CHUNK, G = 1024, 24, 16, 128, 2  # 8 chunks, 4 merge groups
CFG = tr.RCCAConfig(k=3, p=5, q=1, nu=0.01, center=True)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    data = PlantedCCAData(n=N, da=DA, db=DB, rank=4, noise=0.4, seed=13, chunk=CHUNK)
    return ingest_planted(str(tmp_path_factory.mktemp("sanitize") / "store"), data)


def _local(store):
    with sanitize.override(True):
        return fit(store, CFG, 7, merge_group=G, device="cpu")


def test_sanitized_fit_is_reproducible_and_leaves_numbers_alone(store, monkeypatch):
    monkeypatch.delenv("RCCA_SANITIZE", raising=False)
    a, b = _local(store), _local(store)
    t = a.diagnostics["sanitize"]
    assert t == b.diagnostics["sanitize"]
    assert [(r["pass_idx"], r["label"]) for r in t] == [
        (p, lab) for p in (0, 1) for lab in ("group:0", "group:1", "group:2", "group:3",
                                             "pass_end")]
    plain = fit(store, CFG, 7, merge_group=G, device="cpu")
    assert "sanitize" not in plain.diagnostics
    assert all(torch.equal(x, y) for x, y in zip(plain[:3], a[:3]))


def test_sanitized_cluster_fit_gives_the_local_trace(store, tmp_path, monkeypatch):
    """Two CPU workers at combine span 1: the coordinator's trace is the
    Local fit's record for record, the site aside; the workers report
    their own groups' fingerprints, the Local fit's."""
    monkeypatch.delenv("RCCA_SANITIZE", raising=False)
    want = _local(store).diagnostics["sanitize"]
    with sanitize.override(True):
        res = fit(store, CFG, 7, topology=Cluster(n_workers=2), merge_group=G,
                  cluster_dir=str(tmp_path / "c"), device="cpu", worker_timeout=240)
    got = res.diagnostics["sanitize"]
    assert {r["site"] for r in got} == {"coordinator_merge"}
    assert sanitize.first_divergence(want, got) is not None
    assert sanitize.first_divergence(want, got, ignore=("site",)) is None
    groups = {(r["pass_idx"], r["label"]): r["digest"]
              for p in res.diagnostics["cluster"]["passes"] for w in p["workers"]
              for r in w["sanitize"]}
    assert groups == {(r["pass_idx"], r["label"]): r["digest"] for r in want
                      if r["label"].startswith("group:")}


def test_two_fits_on_two_threads_keep_separate_traces(store, monkeypatch):
    """Two sanitized fits in lockstep on two threads (a barrier at every
    chunk): each trace is its fit's alone, as when it runs by itself."""
    monkeypatch.setenv("RCCA_SANITIZE", "1")
    barrier = threading.Barrier(2, timeout=60)

    def run(seed, step):
        def source():
            for i in range(store.n_chunks):
                step()
                yield store.get_chunk(i)
        return tr.randomized_cca_iterator(source, DA, DB, CFG, seed=seed, merge_group=G,
                                          n_chunks=store.n_chunks, device="cpu"
                                          ).diagnostics["sanitize"]

    want = {s: run(s, lambda: None) for s in (7, 8)}
    got, errors = {}, []

    def worker(s):
        try:
            got[s] = run(s, barrier.wait)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in (7, 8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and got == want
    assert want[7] != want[8] and len(want[7]) == 10
