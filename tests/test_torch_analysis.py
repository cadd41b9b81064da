"""The port's analysis gates against the reference's own linters (CPU,
AST and plan lints only; the step census is tests/test_torch_census.py).

- Parity: every rule that ports unchanged (``mutable-default``,
  ``axis-name``, the four thread rules, resource pairing) gives the same
  findings — rule, line, severity, suppression — from the reference's
  linter and the port's on the same source texts: every fixture string
  of ``tests/test_graph_lint.py`` / ``tests/test_contract_lint.py``,
  placed under each package's scope, and the port's serving modules.
- Plan lint: the port's ``lint_plan`` on the port's shipped plans and
  the reference's on the reference's give equal findings, clean and
  with seeded faults (dead, duplicate, shadowed, indivisible, giant).
- Each renamed rule fires on a seeded fault and passes its fixed form.
- The port's whole tree lints clean under the source, thread and
  contract rules apart from its recorded warn baseline, and its
  ``port-imports`` rule agrees with a grep for jax / reference imports.
- C9 / C10: ``native.available()``, ``utils.misc.nll_to_perplexity``,
  and the traced ``native.build`` lock.
- ``NOT_PORTED_RULES`` lists exactly the reference rules with no port
  counterpart.
"""

import ast
import dataclasses
import os
import re
import textwrap

import pytest

from distkeras_tpu.analysis import contract_lint as j_contract
from distkeras_tpu.analysis import shard_lint as j_shard
from distkeras_tpu.analysis import source_lint as j_source
from distkeras_tpu.analysis import thread_lint as j_thread
from distkeras_tpu_torch import analysis as t_analysis
from distkeras_tpu_torch.analysis import contract_lint as t_contract
from distkeras_tpu_torch.analysis import shard_lint as t_shard
from distkeras_tpu_torch.analysis import source_lint as t_source
from distkeras_tpu_torch.analysis import thread_lint as t_thread
from distkeras_tpu_torch.analysis.__main__ import (BASELINE_PATH,
                                                   contract_findings,
                                                   source_findings,
                                                   thread_findings)
from distkeras_tpu_torch.analysis.findings import (apply_baseline,
                                                   load_baseline)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "distkeras_tpu_torch")
UNCHANGED_SOURCE_RULES = {"mutable-default", "axis-name"}
SUBPATHS = ("serving/foo.py", "obs/foo.py", "trainers/foo.py",
            "models/foo.py", "utils/locks.py", "native/__init__.py",
            "data/prefetch.py")


def _fixtures():
    """Every string constant of the reference's lint tests that parses
    as a module with a def, class or assignment."""
    out = []
    for name in ("test_graph_lint.py", "test_contract_lint.py"):
        with open(os.path.join(REPO, "tests", name), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            src = textwrap.dedent(node.value)
            try:
                body = ast.parse(src).body
            except SyntaxError:
                continue
            if any(isinstance(s, (ast.FunctionDef, ast.ClassDef, ast.Assign,
                                  ast.Import, ast.ImportFrom)) for s in body):
                out.append(src)
    return out


FIXTURES = _fixtures()


def _key(findings, rules=None):
    return sorted((f.rule, f.line, f.severity, f.suppressed)
                  for f in findings if rules is None or f.rule in rules)


def test_fixture_corpus_is_the_reference_tests():
    assert len(FIXTURES) >= 40
    joined = "\n".join(FIXTURES)
    for needle in ("threading.Lock()", "_subscribers", "alloc(",
                   "pin_prefix", 'P("dta"', "hooks=[]"):
        assert needle in joined, needle


@pytest.mark.parametrize("sub", SUBPATHS)
def test_source_rules_match_the_reference(sub):
    """mutable-default and axis-name: same findings on every fixture."""
    hits = 0
    for src in FIXTURES:
        want = _key(j_source.lint_source(src, f"distkeras_tpu/{sub}"),
                    UNCHANGED_SOURCE_RULES)
        got = _key(t_source.lint_source(src, f"distkeras_tpu_torch/{sub}"),
                   UNCHANGED_SOURCE_RULES)
        assert got == want, src
        hits += len(got)
    assert hits >= 2


@pytest.mark.parametrize("sub", SUBPATHS)
def test_thread_rules_match_the_reference(sub):
    """The four thread rules, scoped alike (the reference's scope mapped
    to the port's package), give the same findings."""
    hits = set()
    for src in FIXTURES:
        want = _key(j_thread.lint_source_threads(
            src, f"distkeras_tpu/{sub}"))
        got = _key(t_thread.lint_source_threads(
            src, f"distkeras_tpu_torch/{sub}"))
        assert got == want, src
        hits |= {k[0] for k in got}
    if sub == "serving/foo.py":
        assert hits == {"raw-lock", "lock-callback", "lock-blocking",
                        "lock-double-acquire"}
    if sub == "models/foo.py":
        assert not hits   # outside the threaded core


def test_resource_pairing_matches_the_reference():
    n = 0
    for src in FIXTURES:
        want = _key(j_contract.lint_resource_source(src))
        got = _key(t_contract.lint_resource_source(src))
        assert got == want, src
        n += len(got)
    assert n >= 5
    # ... and on the port's own serving modules, source for source.
    for f in t_source.iter_py_files([os.path.join(PORT, "serving")]):
        with open(f, encoding="utf-8") as fh:
            src = fh.read()
        assert _key(t_contract.lint_resource_source(src, f)) == _key(
            j_contract.lint_resource_source(src, f)), f


def test_thread_lint_scope_is_the_ports_threaded_core():
    scoped = {os.path.relpath(f, REPO).replace(os.sep, "/")
              for f in t_source.iter_py_files([PORT])
              if t_thread._in_scope(f)}
    for want in ("distkeras_tpu_torch/serving/lanes.py",
                 "distkeras_tpu_torch/obs/live.py",
                 "distkeras_tpu_torch/resilience/cluster.py",
                 "distkeras_tpu_torch/native/__init__.py",
                 "distkeras_tpu_torch/checkpoint.py",
                 "distkeras_tpu_torch/data/prefetch.py",
                 "distkeras_tpu_torch/utils/misc.py",
                 "distkeras_tpu_torch/utils/locks.py"):
        assert want in scoped, want
    assert not any(s.startswith(("distkeras_tpu_torch/models/",
                                 "distkeras_tpu_torch/trainers/"))
                   for s in scoped)
    # The reference's scope skips the port: the reason this port exists.
    assert not j_thread._in_scope("distkeras_tpu_torch/serving/lanes.py")


# ----------------------------------------------------------- plan lint


def _reference_suite():
    return {name: (rules, tree, axes)
            for name, rules, tree, axes in j_shard.plan_suite()
            if "state_rules" not in name}


@pytest.fixture(scope="module")
def suites():
    return _reference_suite(), {n: (r, t, a) for n, r, t, a
                                in t_shard.plan_suite()}


def _plan_key(findings):
    return sorted((f.rule, f.severity, f.path, f.message) for f in findings)


def test_plan_suite_is_the_references_less_the_zero_state_rules(suites):
    ref, port = suites
    assert set(port) == set(ref)
    assert set(t_shard.NOT_PORTED_PLANS) == {
        n for n, *_ in j_shard.plan_suite()} - set(port)


@pytest.mark.parametrize("name", ["serving_plan", "tp_rules",
                                  "fsdp_plan+tp_rules",
                                  "exchange_codec_rules"])
def test_shipped_plans_lint_alike_and_clean(suites, name):
    ref, port = suites
    want = j_shard.lint_plan(*ref[name][:2], name=name,
                             axis_sizes=ref[name][2])
    got = t_shard.lint_plan(*port[name][:2], name=name,
                            axis_sizes=port[name][2])
    assert _plan_key(got) == _plan_key(want)
    assert not [f for f in got if f.gating]


def _seeded(P, tp_rules):
    """Faulty plans in one package's spelling: ``{fault: (rules,
    axis_sizes, giant_bytes)}``."""
    rules = list(tp_rules())
    return {
        "dead": (rules + [("layers/attn/wqq", P("model"))],
                 {"data": 4, "model": 2}, 1 << 20),
        "duplicate": ([rules[0]] + rules, {"data": 4, "model": 2}, 1 << 20),
        "shadowed": ([(".*", P())] + rules, {"data": 4, "model": 2},
                     1 << 20),
        "indivisible": (rules, {"data": 4, "model": 3}, 1 << 20),
        "giant": ([r for r in rules if "emb" not in r[0]],
                  {"data": 4, "model": 2}, 1024),
    }


@pytest.mark.parametrize("fault", ["dead", "duplicate", "shadowed",
                                   "indivisible", "giant"])
def test_seeded_plan_faults_lint_alike(suites, fault):
    from jax.sharding import PartitionSpec as JP

    from distkeras_tpu.models import transformer as jtfm
    from distkeras_tpu_torch.models import transformer as ttfm
    from distkeras_tpu_torch.parallel.rules import P as TP

    ref, port = suites
    jrules, axes, giant = _seeded(JP, jtfm.tp_rules)[fault]
    trules, _, _ = _seeded(TP, ttfm.tp_rules)[fault]
    want = j_shard.lint_plan(jrules, ref["tp_rules"][1], name=fault,
                             axis_sizes=axes, giant_bytes=giant)
    got = t_shard.lint_plan(trules, port["tp_rules"][1], name=fault,
                            axis_sizes=axes, giant_bytes=giant)
    assert _plan_key(got) == _plan_key(want)
    expect = {"dead": "dead-rule", "duplicate": "duplicate-pattern",
              "shadowed": "shadowed-rule",
              "indivisible": "axis-divisibility",
              "giant": "replicated-giant"}[fault]
    assert expect in {f.rule for f in got}


# ------------------------------------------------------- renamed rules


def _rules(findings):
    return {f.rule for f in findings if not f.suppressed}


def tlint(src, path):
    return t_source.lint_source(textwrap.dedent(src), path=path)


def test_hot_sync_fires_on_host_reads_in_hot_loops():
    for read in ("l.item()", "l.tolist()", "l.cpu()", "l.numpy()",
                 "torch.cuda.synchronize()"):
        src = f"""
            import torch

            def run(losses):
                for l in losses:
                    {read}
        """
        assert "hot-sync" in _rules(tlint(
            src, "distkeras_tpu_torch/trainers/foo.py")), read
        assert "hot-sync" in _rules(tlint(
            src, "distkeras_tpu_torch/serving/foo.py")), read
        # Off the hot paths: no finding.
        assert "hot-sync" not in _rules(tlint(
            src, "distkeras_tpu_torch/data/foo.py"))
    # The fixed form: one read after the loop.
    assert "hot-sync" not in _rules(tlint("""
        import torch

        def run(losses):
            out = []
            for l in losses:
                out.append(l)
            return torch.stack(out).tolist()
    """, "distkeras_tpu_torch/trainers/foo.py"))


def test_import_time_device_fires_on_module_scope_tensors():
    for stmt in ("TABLE = torch.arange(1024)",
                 "X = torch.nn.functional.relu(torch.ones(3))",
                 "N = torch.cuda.device_count()"):
        src = f"import torch\n{stmt}\n"
        assert "import-time-device" in _rules(tlint(
            src, "distkeras_tpu_torch/models/foo.py")), stmt
    assert "import-time-device" not in _rules(tlint("""
        import torch

        F32 = torch.float32
        CPU = torch.device("cpu")

        def table():
            return torch.arange(1024)
    """, "distkeras_tpu_torch/models/foo.py"))


def test_port_imports_fires_on_jax_and_the_reference():
    for stmt in ("import jax", "from jax import numpy as jnp",
                 "import distkeras_tpu", "from distkeras_tpu.obs import "
                 "metrics", "import distkeras_tpu.analysis"):
        src = f"def f():\n    {stmt}\n"
        hits = tlint(src, "distkeras_tpu_torch/serving/foo.py")
        assert "port-imports" in _rules(hits), stmt
        assert all(f.severity == "error" for f in hits
                   if f.rule == "port-imports")
        # The reference's own modules may import jax.
        assert "port-imports" not in _rules(tlint(
            src, "distkeras_tpu/serving/foo.py"))
    assert "port-imports" not in _rules(tlint(
        "import distkeras_tpu_torch\nfrom distkeras_tpu_torch import obs\n"
        "import torch\n", "distkeras_tpu_torch/serving/foo.py"))


def test_torch_free_fires_on_the_ledger_only():
    src = """
        def handler():
            import torch

            return torch.cuda.device_count()
    """
    for f in t_source.TORCH_FREE_FILES:
        assert "torch-free" in _rules(tlint(src, f)), f
    assert "torch-free" not in _rules(tlint(
        src, "distkeras_tpu_torch/serving/lanes.py"))
    assert "torch-free" not in _rules(tlint(
        "import json\nimport threading\n",
        "distkeras_tpu_torch/obs/live.py"))
    # The ledger is the reference's, mapped to the port, on disk.
    assert len(t_source.TORCH_FREE_FILES) == len(j_source._JAX_FREE_FILES)
    for f in t_source.TORCH_FREE_FILES:
        assert os.path.exists(os.path.join(REPO, f)), f


# ----------------------------------------------------- the port's tree


def test_port_tree_lints_clean_apart_from_its_baseline():
    found = source_findings(REPO) + thread_findings(REPO) + \
        contract_findings(REPO)
    found = apply_baseline(found, load_baseline(BASELINE_PATH))
    assert not [f.format() for f in found if f.gating]
    assert not [f for f in found if f.suppressed], \
        "the port's gates ship with zero suppressions"
    # The baseline holds warns only: the tree's, and the card's census
    # targets of chip_smoke.py's phase analysis (f32 accumulation in the
    # bf16 RMS norm and loss, the decode attention's f32 cache reads).
    base = load_baseline(BASELINE_PATH)
    tree = {k: n for k, n in base.items() if k.endswith(".py")}
    assert tree == {"hot-sync:distkeras_tpu_torch/serving/publish.py": 2}
    assert set(base) - set(tree) == {
        "dtype-upcast:flagship/lmtrainer_dp/train_step",
        "dtype-upcast:engine_load/continuousbatcher_greedy/decode_step"}
    assert sum(f.baselined for f in found) == sum(tree.values())


_GREP = re.compile(r"^\s*(import jax|from jax|import distkeras_tpu\b|"
                   r"from distkeras_tpu[ .])")


def test_port_imports_agrees_with_a_grep():
    grep = []
    for f in t_source.iter_py_files([PORT]):
        with open(f, encoding="utf-8") as fh:
            for i, line in enumerate(fh, 1):
                if _GREP.match(line) and not line.lstrip().startswith(
                        "from distkeras_tpu_torch"):
                    grep.append((f, i))
    lint = [(f.path, f.line) for f in t_source.lint_paths([PORT])
            if f.rule == "port-imports"]
    assert grep == lint == []


def test_contract_lint_holds_the_port_to_the_fleet_schema():
    assert not [f.format() for f in t_contract.lint_repo_contracts(REPO)
                if f.gating]
    # Each pinned name the port does not emit carries its reason.
    schema = t_contract.load_obs_schema(
        os.path.join(REPO, "scripts", "obs_schema.json"))
    _, census, _, _ = t_contract.collect_telemetry(REPO)
    assert set(schema["metrics"]) - set(census) == set(
        t_contract.NOT_EMITTED)


# ------------------------------------------------------------ C9, C10


def test_c9_native_available_and_nll_to_perplexity():
    import math

    from distkeras_tpu import native as j_native
    from distkeras_tpu.utils.misc import nll_to_perplexity as j_ppl
    from distkeras_tpu_torch import native
    from distkeras_tpu_torch.utils.misc import nll_to_perplexity

    assert isinstance(native.available(), bool)
    assert native.available() == (native.lib() is not None)
    assert native.available() == j_native.available()
    for v in (0.0, 1.5, 699.0, 700.0, 1e9):
        assert nll_to_perplexity(v) == j_ppl(v)
    assert nll_to_perplexity(2.0) == math.exp(2.0)
    from distkeras_tpu_torch import evaluators
    from distkeras_tpu_torch.trainers import lm
    assert lm.nll_to_perplexity is evaluators.nll_to_perplexity \
        is nll_to_perplexity


def test_c10_native_build_lock_is_traced():
    from distkeras_tpu_torch import native
    from distkeras_tpu_torch.utils import locks

    path = os.path.join(PORT, "native", "__init__.py")
    with open(path, encoding="utf-8") as f:
        src = f.read()
    assert "raw-lock" not in _rules(t_thread.lint_source_threads(src, path))
    assert "raw-lock" not in _rules(j_thread.lint_source_threads(
        src, "distkeras_tpu/native/__init__.py"))
    assert 'TracedLock("native.build")' in src
    if locks.sanitizer_enabled():
        assert getattr(native._lock, "name", None) == "native.build"


# ------------------------------------------------------ not ported


def test_not_ported_rules_are_exactly_the_reference_only_rules():
    assert set(t_analysis.NOT_PORTED_RULES) == {
        "jit-wallclock", "jit-np-random", "jit-no-donate", "loop-jit",
        "donation-unused", "donation-read", "resharding-collective"}
    assert all(len(r) > 40 for r in t_analysis.NOT_PORTED_RULES.values())
    assert t_analysis.RENAMED_RULES == {
        "import-time-jnp": ("import-time-device",),
        "jax-free": ("port-imports", "torch-free"),
        "host-callback": ("host-sync",),
        "prng-reuse": ("global-generator",)}


def test_package_surface_is_the_references():
    import distkeras_tpu.analysis as j_analysis

    assert t_analysis.__all__ == j_analysis.__all__
    for name in t_analysis.__all__:
        assert hasattr(t_analysis, name), name
    assert dataclasses.is_dataclass(t_analysis.TraceSpec)
