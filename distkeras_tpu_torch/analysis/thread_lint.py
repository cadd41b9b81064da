"""Thread-safety source lint over the port's threaded core modules.

The port's copy of ``distkeras_tpu/analysis/thread_lint.py``: the same
four rules, scoped to the port's threaded core.  It is the static half
of the concurrency gate (the dynamic half is
``distkeras_tpu_torch/utils/locks.py``'s runtime sanitizer).  The
concurrency bugs these rules catch are a handful of *source shapes* — a
callback fired under a lock, blocking work while holding a lock, a raw
un-instrumented lock the sanitizer can't see — so this lint turns those
shapes into AST rules over the packages that run threads (``serving/``,
``obs/``, ``resilience/``, ``native/``, ``checkpoint.py``,
``data/prefetch.py``, ``utils/misc.py``, ``utils/locks.py``):

===================  =====  ==============================================
rule id              sev    fires on
===================  =====  ==============================================
raw-lock             error  ``threading.Lock()`` / ``threading.RLock()``
                            / ``threading.Condition()`` constructed in a
                            threaded core module instead of the
                            instrumented :func:`~distkeras_tpu_torch.
                            utils.locks.TracedLock` / ``TracedRLock``
                            wrappers (allowlist: ``utils/locks.py`` itself
                            — the wrappers have to be built out of
                            something)
lock-callback        error  a registered callback / subscriber / hook
                            invoked lexically inside a ``with <lock>:``
                            block — the callee can re-enter the subsystem
                            and deadlock on the very lock the caller
                            holds (``for fn in self._subscribers: fn(...)``
                            under the engine lock)
lock-blocking        warn   a blocking call while holding a lock:
                            ``time.sleep``, ``subprocess.*``, HTTP/socket
                            reads (``urlopen``/``recv``/``accept``), a
                            thread ``join``, an event ``wait`` — every
                            other thread needing the lock stalls for the
                            full blocking duration
lock-double-acquire  error  a ``with <lock>:`` lexically nested inside a
                            ``with <same lock>:`` in one function, where
                            the module constructs that lock NON-reentrant
                            (``TracedLock``/``threading.Lock``) — a
                            certain same-thread deadlock
===================  =====  ==============================================

The analysis is *lexical* (per function body): a def nested inside a
``with lock:`` block runs later, not under the lock, and is excluded;
calls reached through another function while the lock is held are the
dynamic sanitizer's job.  "Callback-shaped" callees are (a) a bare
name bound by a ``for`` over a collection whose name ends in
``subscribers``/``callbacks``/``hooks``/``listeners`` (through
``list()``/``tuple()``/``sorted()``/``reversed()`` wrappers), or (b)
any callee whose final name matches that family.  Suppress per line
with ``# dkt: ignore[rule]`` (findings.py); ``lock-blocking`` warns
take part in the port's warn-baseline ratchet like every other warn
rule.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable

from distkeras_tpu_torch.analysis.findings import (Finding,
                                                   apply_suppressions)
from distkeras_tpu_torch.analysis.source_lint import (_attr_chain,
                                                      iter_py_files)

# The threaded scope: packages/modules that create threads or locks.
_THREADED_DIRS = tuple(
    os.path.join("distkeras_tpu_torch", d)
    for d in ("serving", "obs", "resilience", "native"))
_THREADED_FILES = tuple(
    os.path.join("distkeras_tpu_torch", f)
    for f in ("checkpoint.py",
              os.path.join("data", "prefetch.py"),
              os.path.join("utils", "misc.py"),
              os.path.join("utils", "locks.py")))
# The one legal home of raw lock construction: the wrappers themselves.
_RAW_LOCK_ALLOWLIST = (
    os.path.join("distkeras_tpu_torch", "utils", "locks.py"),)

_RAW_LOCK_CTORS = {"Lock", "RLock", "Condition"}
_TRACED_RLOCK_CTORS = {"RLock", "TracedRLock"}
_TRACED_LOCK_CTORS = {"Lock", "TracedLock"}

_CALLBACK_RE = re.compile(
    r"(callback|subscriber|listener|hook)s?$", re.IGNORECASE)


def _in_scope(path: str) -> bool:
    norm = path.replace(os.sep, "/")
    return (any(d.replace(os.sep, "/") + "/" in norm
                for d in _THREADED_DIRS)
            or any(norm.endswith(f.replace(os.sep, "/"))
                   for f in _THREADED_FILES))


def _is_lock_expr(node) -> str | None:
    """The dotted chain of a with-item that looks like a lock
    (``self._lock``, ``self._admission_lock``, module-level ``_lock``)
    — the final name must contain "lock"."""
    chain = _attr_chain(node)
    if chain and "lock" in chain[-1].lower():
        return ".".join(chain)
    return None


def _unwrap_iter(node):
    """``list(self._subscribers)`` -> ``self._subscribers`` (also
    tuple/sorted/reversed, one level each)."""
    while (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
           and node.func.id in ("list", "tuple", "sorted", "reversed")
           and len(node.args) == 1):
        node = node.args[0]
    return node


def _callbackish(name: str) -> bool:
    return bool(_CALLBACK_RE.search(name.lstrip("_")))


def _blocking_reason(chain: list[str], name: str) -> str | None:
    """Why this call blocks, or None.  Receiver-sensitive checks
    (``join``/``wait``/``recv``) key off the receiver's name so that
    e.g. ``", ".join(...)`` never fires."""
    if name == "sleep" and (len(chain) == 1 or chain[-2] == "time"):
        return "time.sleep while holding a lock"
    if chain[:1] == ["subprocess"]:
        return f"subprocess.{name} while holding a lock"
    if name == "urlopen":
        return "an HTTP read while holding a lock"
    if name in ("recv", "recvfrom", "accept") and len(chain) >= 2:
        return f"a socket {name} while holding a lock"
    if name == "join" and len(chain) >= 2 \
            and "thread" in chain[-2].lower():
        return "a thread join while holding a lock"
    if name == "wait" and len(chain) >= 2 and any(
            k in chain[-2].lower()
            for k in ("event", "stop", "halt", "done", "cond")):
        return "an event wait while holding a lock"
    return None


def _collect_lock_kinds(tree: ast.Module) -> tuple[set, set]:
    """Names/attrs this module binds to a reentrant vs non-reentrant
    lock constructor (``self._x = TracedRLock()`` -> ``_x`` reentrant).
    Drives ``lock-double-acquire``: only locks this module *provably*
    constructs non-reentrant are flagged."""
    reentrant, nonreentrant = set(), set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        value = node.value
        if not isinstance(value, ast.Call):
            continue
        chain = _attr_chain(value.func)
        ctor = chain[-1] if chain else ""
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            tchain = _attr_chain(t)
            if not tchain:
                continue
            attr = tchain[-1]
            if ctor in _TRACED_RLOCK_CTORS:
                reentrant.add(attr)
            elif ctor in _TRACED_LOCK_CTORS:
                nonreentrant.add(attr)
    return reentrant, nonreentrant


def _collect_threading_imports(tree: ast.Module) -> tuple[set, set]:
    """Local names the module binds to the ``threading`` module
    (``import threading [as t]``) and to its raw lock constructors
    (``from threading import Lock [as L]``) — so the ``raw-lock``
    rule catches every spelling, not just the literal
    ``threading.Lock()``."""
    mod_aliases, ctor_names = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "threading":
                    mod_aliases.add(a.asname or "threading")
        elif isinstance(node, ast.ImportFrom) and node.module == "threading":
            for a in node.names:
                if a.name in _RAW_LOCK_CTORS:
                    ctor_names.add(a.asname or a.name)
    return mod_aliases, ctor_names


class _ThreadLinter(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.lines = source.splitlines()
        self.findings: list[Finding] = []
        self._held: list[str] = []       # with-lock chains, current fn
        self._sub_names: set[str] = set()  # for-targets over callbacks
        self._reentrant: set[str] = set()
        self._nonreentrant: set[str] = set()
        self._thr_aliases: set[str] = set()
        self._thr_ctors: set[str] = set()

    def run(self, tree: ast.Module) -> list[Finding]:
        self._reentrant, self._nonreentrant = _collect_lock_kinds(tree)
        self._thr_aliases, self._thr_ctors = \
            _collect_threading_imports(tree)
        self.visit(tree)
        return self.findings

    def add(self, rule: str, severity: str, node, message: str,
            hint: str = ""):
        line = getattr(node, "lineno", None)
        f = Finding(rule=rule, severity=severity, path=self.path,
                    line=line, message=message, hint=hint)
        if line is not None and line - 1 < len(self.lines):
            f = apply_suppressions(f, self.lines[line - 1])
        self.findings.append(f)

    # ------------------------------------------------- scope plumbing

    def visit_FunctionDef(self, node):
        # A def nested under a with-lock runs LATER, not under the
        # lock: fresh held/subscriber state for its body.
        held, subs = self._held, self._sub_names
        self._held, self._sub_names = [], set()
        self.generic_visit(node)
        self._held, self._sub_names = held, subs

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_With(self, node: ast.With):
        chains = [c for c in (_is_lock_expr(i.context_expr)
                              for i in node.items) if c is not None]
        for chain in chains:
            if chain in self._held:
                attr = chain.rsplit(".", 1)[-1]
                # Flag only when the module PROVABLY constructs this
                # attr non-reentrant: an attr bound reentrant anywhere
                # in the module (e.g. two classes sharing the name) is
                # ambiguous, not proof.
                if (attr in self._nonreentrant
                        and attr not in self._reentrant):
                    self.add(
                        "lock-double-acquire", "error", node,
                        f"`with {chain}:` nested inside a `with "
                        f"{chain}:` block, and this module constructs "
                        f"{attr!r} NON-reentrant",
                        "a plain Lock re-acquired by its owner "
                        "deadlocks; make it a TracedRLock or hoist "
                        "the outer acquisition")
        self._held.extend(chains)
        self.generic_visit(node)
        del self._held[len(self._held) - len(chains):]

    def visit_For(self, node: ast.For):
        it = _unwrap_iter(node.iter)
        chain = _attr_chain(it)
        if chain and _callbackish(chain[-1]) \
                and isinstance(node.target, ast.Name):
            self._sub_names.add(node.target.id)
        self.generic_visit(node)

    # ----------------------------------------------------------- rules

    def visit_Call(self, node: ast.Call):
        chain = _attr_chain(node.func)
        name = chain[-1] if chain else ""

        raw = ((len(chain) == 2 and chain[0] in self._thr_aliases
                and name in _RAW_LOCK_CTORS)
               or (len(chain) == 1 and name in self._thr_ctors))
        if raw:
            norm = self.path.replace(os.sep, "/")
            allowed = any(norm.endswith(a.replace(os.sep, "/"))
                          for a in _RAW_LOCK_ALLOWLIST)
            if not allowed:
                self.add(
                    "raw-lock", "error", node,
                    f"raw threading lock (`{'.'.join(chain)}()`) "
                    "constructed in a threaded core module",
                    "use TracedLock/TracedRLock from distkeras_tpu_"
                    "torch.utils.locks so the lock-order sanitizer can "
                    "see it (free when disabled)")

        if self._held:
            is_cb = (isinstance(node.func, ast.Name)
                     and node.func.id in self._sub_names)
            if not is_cb and name and _callbackish(name):
                is_cb = True
            if is_cb:
                self.add(
                    "lock-callback", "error", node,
                    f"callback `{'.'.join(chain) or name}` invoked "
                    f"inside a `with {self._held[-1]}:` block",
                    "a subscriber may call back into this subsystem "
                    "and deadlock on the held lock (the slo.breach "
                    "shape); collect under the lock, fire "
                    "after release, and guard the fire site with "
                    "locks.assert_unlocked()")
            reason = _blocking_reason(chain, name)
            if reason is not None:
                self.add(
                    "lock-blocking", "warn", node,
                    f"{reason} (`{'.'.join(chain) or name}` under "
                    f"`with {self._held[-1]}:`)",
                    "every thread needing this lock stalls for the "
                    "full blocking duration; move the blocking work "
                    "outside the critical section")

        self.generic_visit(node)


def lint_source_threads(source: str, path: str = "<string>"
                        ) -> list[Finding]:
    """Thread-safety lint over one source string.  Out-of-scope paths
    return no findings (the rules only apply to the threaded core)."""
    if not _in_scope(path):
        return []
    tree = ast.parse(source, filename=path)
    return _ThreadLinter(path, source).run(tree)


def lint_paths_threads(paths: Iterable[str]) -> list[Finding]:
    """Thread-safety lint over files/directories (``.py``,
    recursively; out-of-scope files are skipped)."""
    findings: list[Finding] = []
    for f in iter_py_files(paths):
        if not _in_scope(f):
            continue
        with open(f, encoding="utf-8") as fh:
            findings.extend(lint_source_threads(fh.read(), path=f))
    return findings


__all__ = ["lint_source_threads", "lint_paths_threads"]
