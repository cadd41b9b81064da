"""Source lint: an AST rule engine with the port's rules.

The port's counterpart of ``distkeras_tpu/analysis/source_lint.py``.
The step census (``ir_lint.py``) sees what one step dispatches; this
layer catches the hazards that never reach a dispatched op — host syncs
in hot loops, device work at import time, a JAX import in the port.
Rules:

=================  =====  ==================================================
rule id            sev    fires on
=================  =====  ==================================================
hot-sync           warn   ``.item()`` / ``.tolist()`` / ``.cpu()`` /
                          ``.numpy()`` / ``torch.cuda.synchronize()`` in a
                          for/while body of a trainer or serving module —
                          a device-to-host wait per iteration on the hot
                          path
import-time-device warn   a tensor constructor or op (``torch.zeros``,
                          ``torch.nn.functional.*``, ...) or any
                          ``torch.cuda.*`` call at module scope: device
                          work (and CUDA initialization) at import time —
                          the port must import on a CPU box
mutable-default    error  mutable default argument (list/dict/set) on a
                          public function
axis-name          error  a mesh-axis string in ``P(...)`` or an
                          ``axis_name=`` / ``axis=`` argument that is not
                          one of the canonical ``parallel.mesh.AXES``
                          (typos silently replicate)
port-imports       error  any ``jax`` or ``distkeras_tpu`` import,
                          anywhere in the port: the port keeps its own
                          copy of what it needs from the reference
torch-free         error  any ``torch`` import in a module on the
                          TORCH-FREE ledger (:data:`TORCH_FREE_FILES`:
                          the live and offline telemetry plane, the lock
                          sanitizer, the router plane, the autoscaler and
                          its load generator) — they run on scrape, ticker
                          and router threads, or in stdlib-only children,
                          and must never be able to touch the device
=================  =====  ==================================================

The reference's traced-function rules have no port counterpart: eager
torch traces and compiles nothing, so there is no traced body for them
to look inside (:data:`NOT_PORTED_RULES`).  Suppress per line with
``# dkt: ignore[rule]`` (see findings.py).
"""

from __future__ import annotations

import ast
import os
from typing import Iterable

from distkeras_tpu_torch.analysis.findings import Finding, apply_suppressions
from distkeras_tpu_torch.parallel.mesh import AXES

_PORT = "distkeras_tpu_torch"
_REFERENCE = "distkeras_tpu"

_EAGER = ("eager torch traces and compiles nothing: a step is Python "
          "that runs each call, so there is no traced body whose value "
          "freezes at trace time")
#: The reference's source rules with no port counterpart, each with
#: its reason.
NOT_PORTED_RULES = {
    "jit-wallclock": _EAGER + " (a clock read runs every step)",
    "jit-np-random": _EAGER + " (a host draw runs every step)",
    "jit-no-donate": _EAGER + "; the port's steps update their state "
                              "in place, so no carry is copied",
    "loop-jit": _EAGER + "; there is no jit wrapper to hoist",
}

#: Reference rule -> the port rule(s) that take its place.
RENAMED_RULES = {
    "import-time-jnp": ("import-time-device",),
    "jax-free": ("port-imports", "torch-free"),
}

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOT_PATH_DIRS = (os.path.join(_PORT, "trainers"),
                  os.path.join(_PORT, "serving"))
# The TORCH-FREE ledger: the reference's JIT-FREE ledger
# (``_JAX_FREE_FILES``) mapped to the port — the live telemetry plane
# and the offline obs modules (scrape/SLO threads, no-framework report
# loaders), the lock sanitizer (imported by every module above and by
# the cluster layer's stdlib children), the router plane (routing is
# host bookkeeping and HTTP), and the autoscaling control plane with
# its trace-replay load generator.
TORCH_FREE_FILES = tuple(
    os.path.join(_PORT, "obs", f)
    for f in ("live.py", "slo.py", "metrics.py", "trace.py",
              "report.py")) + (
    os.path.join(_PORT, "utils", "locks.py"),
    os.path.join(_PORT, "serving", "router.py"),
    os.path.join(_PORT, "serving", "residency.py"),
    os.path.join(_PORT, "serving", "autoscale.py"),
    os.path.join(_PORT, "serving", "traffic.py"))
# ``torch.X(...)`` calls at module scope that build no tensor and touch
# no device: dtype/device descriptors, grad-mode switches, registries.
_SAFE_TORCH_CALLS = {
    "device", "dtype", "Size", "finfo", "iinfo", "no_grad",
    "enable_grad", "inference_mode", "set_grad_enabled",
    "get_default_dtype", "is_tensor", "is_grad_enabled",
}
# Sub-namespaces whose calls are tensor ops.
_OP_NAMESPACES = {"nn.functional", "linalg", "fft", "special", "cuda"}


def _attr_chain(node) -> list[str]:
    """``a.b.c`` -> ["a", "b", "c"]; non-chains -> []."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def _call_name(call: ast.Call) -> str:
    chain = _attr_chain(call.func)
    return chain[-1] if chain else ""


def _device_call(chain: list[str]) -> bool:
    """Is ``chain`` a tensor constructor / op or a ``torch.cuda`` call?"""
    if chain[:1] != ["torch"] or len(chain) < 2:
        return False
    if len(chain) == 2:
        return chain[1] not in _SAFE_TORCH_CALLS and not chain[1][:1].isupper()
    return ".".join(chain[1:-1]) in _OP_NAMESPACES


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def _in_port(path: str) -> bool:
    return f"{_PORT}/" in _norm(path)


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.lines = source.splitlines()
        self.findings: list[Finding] = []
        self._parents: dict[ast.AST, ast.AST] = {}

    # ---------------------------------------------------------- plumbing

    def run(self, tree: ast.Module) -> list[Finding]:
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self._parents[child] = node
        self.visit(tree)
        return self.findings

    def add(self, rule: str, severity: str, node: ast.AST, message: str,
            hint: str = ""):
        line = getattr(node, "lineno", None)
        f = Finding(rule=rule, severity=severity, path=self.path,
                    line=line, message=message, hint=hint)
        if line is not None and line - 1 < len(self.lines):
            f = apply_suppressions(f, self.lines[line - 1])
        self.findings.append(f)

    def _enclosing_defs(self, node) -> Iterable[ast.AST]:
        cur = node
        while cur in self._parents:
            cur = self._parents[cur]
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                yield cur

    def _in_loop(self, node) -> bool:
        cur = node
        while cur in self._parents:
            parent = self._parents[cur]
            if isinstance(parent, (ast.For, ast.While)) and (
                    cur in parent.body or cur in parent.orelse):
                return True
            if isinstance(parent, (ast.FunctionDef,
                                   ast.AsyncFunctionDef, ast.Lambda)):
                return False
            cur = parent
        return False

    # ------------------------------------------------------------- rules

    def visit_Call(self, node: ast.Call):
        chain = _attr_chain(node.func)
        name = (chain[-1] if chain else node.func.attr
                if isinstance(node.func, ast.Attribute) else "")

        sync = ((isinstance(node.func, ast.Attribute)
                 and name in _SYNC_METHODS and not node.args
                 and not node.keywords)
                or chain[:3] == ["torch", "cuda", "synchronize"])
        if sync and self._hot_path() and self._in_loop(node):
            self.add("hot-sync", "warn", node,
                     f"`{name}` inside a loop on a trainer/serving hot "
                     "path",
                     "a device-to-host wait per iteration serializes "
                     "dispatch; read once after the loop, or justify with "
                     "a dkt: ignore")

        if name in ("P", "PartitionSpec"):
            for arg in node.args:
                self._check_axis_value(arg)
        for k in node.keywords:
            if k.arg in ("axis_name", "axis") and isinstance(
                    k.value, ast.Constant) and isinstance(
                        k.value.value, str):
                self._check_axis_value(k.value)

        self.generic_visit(node)

    def _check_axis_value(self, node):
        values = [node]
        if isinstance(node, (ast.Tuple, ast.List)):
            values = list(node.elts)
        for v in values:
            if (isinstance(v, ast.Constant) and isinstance(v.value, str)
                    and v.value not in AXES):
                self.add("axis-name", "error", v,
                         f"axis name {v.value!r} is not one of the "
                         f"canonical mesh axes {AXES}",
                         "a typo here silently replicates instead of "
                         "sharding; use parallel.mesh.AXES names")

    def _hot_path(self) -> bool:
        norm = _norm(self.path)
        return any(_norm(d) + "/" in norm for d in _HOT_PATH_DIRS)

    def _torch_free(self) -> bool:
        norm = _norm(self.path)
        return any(norm.endswith(_norm(f)) for f in TORCH_FREE_FILES)

    def _check_imports(self, node, modules) -> None:
        port, torch_free = _in_port(self.path), self._torch_free()
        for mod in modules:
            root = (mod or "").split(".")[0]
            if port and root in ("jax", _REFERENCE):
                self.add("port-imports", "error", node,
                         f"`{mod}` imported in the port "
                         f"({os.path.basename(self.path)})",
                         "the port imports neither jax nor the reference "
                         "package; keep a copy of what it needs")
            if torch_free and root == "torch":
                self.add("torch-free", "error", node,
                         f"`{mod}` imported in a torch-free module "
                         f"({os.path.basename(self.path)})",
                         "the telemetry, lock and router planes must "
                         "never be able to touch the device; move the "
                         "dependency out or read the data through the "
                         "registry/trace instead")

    def visit_Import(self, node: ast.Import):
        self._check_imports(node, [a.name for a in node.names])
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if not node.level:
            self._check_imports(node, [node.module])
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef):
        if not node.name.startswith("_"):
            for default in (node.args.defaults
                            + [d for d in node.args.kw_defaults if d]):
                bad = isinstance(default, (ast.List, ast.Dict, ast.Set))
                if (isinstance(default, ast.Call)
                        and _call_name(default) in ("list", "dict", "set")):
                    bad = True
                if bad:
                    self.add("mutable-default", "error", default,
                             f"mutable default argument on public "
                             f"function `{node.name}`",
                             "the default is shared across calls; "
                             "default to None and build inside")
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Module(self, node: ast.Module):
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Import,
                                 ast.ImportFrom)):
                continue
            for call in ast.walk(stmt):
                if not isinstance(call, ast.Call):
                    continue
                # Skip calls nested inside defs/lambdas under this stmt
                # (e.g. a module-level dict of lambdas is lazy).
                if any(isinstance(d, (ast.FunctionDef, ast.Lambda))
                       for d in self._enclosing_defs(call)):
                    continue
                chain = _attr_chain(call.func)
                if _device_call(chain):
                    self.add("import-time-device", "warn", call,
                             f"`{'.'.join(chain)}` call at module "
                             "import time",
                             "device work (and CUDA initialization) on "
                             "import; build tensors lazily, inside the "
                             "function that uses them")
        self.generic_visit(node)


def lint_source(source: str, path: str = "<string>") -> list[Finding]:
    """Lint one python source string."""
    tree = ast.parse(source, filename=path)
    return _Linter(path, source).run(tree)


def iter_py_files(paths: Iterable[str]) -> list[str]:
    """Expand files/directories into the sorted ``.py`` file list every
    lint layer walks (``__pycache__`` skipped) — ONE walker, so
    file-selection fixes cannot drift between them."""
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                if "__pycache__" in root:
                    continue
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
        else:
            files.append(p)
    return sorted(files)


def lint_paths(paths: Iterable[str]) -> list[Finding]:
    """Lint files/directories (``.py`` files, recursively)."""
    findings: list[Finding] = []
    for f in iter_py_files(paths):
        with open(f, encoding="utf-8") as fh:
            findings.extend(lint_source(fh.read(), path=f))
    return findings


__all__ = ["lint_source", "lint_paths", "iter_py_files"]
