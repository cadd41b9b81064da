"""Contract lint: the static witness for the port's coordination contracts.

The port's copy of ``distkeras_tpu/analysis/contract_lint.py``, over the
port's producers, servers and clients.  The step census pins collective
traffic (``comm_budget.json``), the shard lint pins placements
(``shard_budget.json``), the thread lint pins the lock shapes; this
module pins the THREE contracts the serving fleet and the autoscaler
close their loops on:

* **Telemetry schema** — every ``obs.count/gauge/observe/event/span``
  emission site's name, instrument kind, and label-key set, censused by
  AST walk over ``distkeras_tpu_torch/`` and pinned exactly in the
  fleet's one schema, ``scripts/obs_schema.json`` (the port emits the
  reference's names, so both packages answer to the same file; it is
  read as data, and only ``scripts/graph_lint.py --update-budgets``
  re-records it).  A renamed metric, a changed label set, or a name
  claimed by two instrument kinds silently blinds every consumer
  (``obs/report.py``, the SLO engine, the chaos suite, the serving
  bench) — here each becomes a lint error at the emitting line.
* **Wire protocol** — the route census of every HTTP server
  (``EngineEndpoint`` ``do_GET``/``do_POST``, ``TelemetryServer``'s
  handler) cross-checked both directions against every client
  (``HttpReplica``, the federation scraper, the chaos-suite probes):
  path, method, query params, and status codes, pinned in the same
  schema file.
* **Resource pairing** — per-function control-flow proof over
  ``serving/`` that every acquire (``alloc``/``share_by_hash``/
  ``acquire``/``pin_prefix``/``import_blocks``) reaches its paired
  release on every path *including exception edges*.

Rules::

    metric-drift        error  emitted-but-unpinned / pinned-but-gone /
                               instrument kind changed vs the schema
    metric-collision    error  one name, two instrument kinds (or two
                               names aliasing one Prometheus family)
    label-drift         error  a site's label-key union != the schema
    dangling-consumer   error  a consumer references a name no producer
                               emits
    undocumented-metric warn   censused name absent from the
                               docs/observability.md instrumentation
                               tables (baselineable)
    route-drift         error  client calls an unserved route / served
                               route has neither a client nor an
                               operator flag / census != schema
    status-drift        warn   a client explicitly checks a status code
                               the server never sends on that route
    unbalanced-resource error  an acquire can escape its function (or
                               die on an exception edge) without its
                               paired release

Dynamic-name emission sites cannot be censused literally; the names
they are known to produce are declared in :data:`DYNAMIC_METRICS` and
pinned in the schema's ``dynamic_metrics`` list so consumer references
to them still resolve.  The operator scripts under ``scripts/`` (the
chaos suite, the serving bench, the report CLI) drive the fleet over
its wire and read its telemetry: their client calls, consumer
references and the events their generated child sources emit (a
raw-regex sweep, ``scenario_events``) are read as source text, never
imported.

Everything here is pure ``ast`` + the findings machinery + the
``prom_name`` ledger, importable without torch touching a device.
"""

from __future__ import annotations

import ast
import json
import os
import re

from .findings import Finding, apply_suppressions
from .source_lint import _attr_chain, iter_py_files

# --------------------------------------------------------------- census config

#: ``obs`` facade methods -> instrument kind.
FACADE_KINDS = {"count": "counter", "gauge": "gauge",
                "observe": "histogram", "event": "event", "span": "span",
                "device_span": "span"}

#: Registry factory methods -> instrument kind (``sess.registry.counter(
#: "name", ...)`` style, chained or assigned to a local).
REGISTRY_KINDS = {"counter": "counter", "gauge": "gauge",
                  "histogram": "histogram"}

#: Instrument-handle methods whose keywords are label keys.
OBSERVER_METHODS = {"inc", "set", "observe"}

#: Per-kind keyword names that are call parameters, not labels.
NON_LABEL_KW = {"counter": {"n"}, "gauge": {"value"},
                "histogram": {"value", "buckets"},
                "event": set(), "span": set()}

#: A metric/event name: at least two dotted lowercase segments.
NAME_RE = re.compile(r"^[a-z0-9_]+(?:\.[a-z0-9_]+)+$")

#: Trailing segments that mark a dotted string as a filename, not a
#: metric name (consumer-reference noise filter).
_FILE_EXT = {"py", "json", "jsonl", "md", "txt", "log", "yaml", "yml",
             "addr", "tmp", "csv", "html"}

#: Names emitted through dynamic-name sites the AST census cannot see:
#: ``StepTimer`` (``f"{scope}.{name}"`` spans / ``_s`` histograms /
#: ``.round`` events, scope defaults to ``train``), the trainer probe
#: gauges (``f"train.{k}"``), and the lock sanitizer's ``_observe``
#: indirection.  Declared here, pinned into the schema, consulted by
#: the dangling-consumer rule.
DYNAMIC_METRICS = {
    "train.step_s": "histogram",
    "train.h2d_s": "histogram",
    "train.step": "span",
    "train.h2d": "span",
    "train.round": "event",
    "lock.held_s": "histogram",
    "lock.wait_s": "histogram",
}

#: Pinned names the port never emits, each with its reason: the schema
#: check holds the census to the pinned set less these.
NOT_EMITTED = {
    "serving.compile_tiers": "eager torch compiles nothing: the elastic "
                             "engine has no per-tier program warm-up",
    "serving.compile_warm": "eager torch compiles nothing: an engine has "
                            "no program to warm before it serves",
}

#: Where the port's census departs from the fleet schema (the
#: reference's census, which the port may not re-record): names only the
#: port emits, and label keys only the port adds to a pinned name, each
#: pinned here as ``name: (kind, label keys, reason)``.  The schema check
#: holds the census to the pinned set with these laid over it, and the
#: reason documents the name for the doc-coverage check.
PORT_ONLY = {
    "serving.dispatch": ("span", ("n",),
                         "the host enqueueing a decode window, inside "
                         "serving.step (the benchmark's "
                         "decode_dispatch_ms)"),
    "serving.readback": ("span", ("n",),
                         "the host waiting for the card and copying a "
                         "window's tokens back, inside serving.step"),
    "serving.admit": ("span", ("bucket", "chunks", "lane", "request_id",
                               "tokens"),
                      "tokens: the real prompt tokens in the bucket-"
                      "padded chunk (the benchmark's admit_pad_share)"),
    "serving.admit_chunk": ("span", ("bucket", "remaining", "request_id",
                                     "tokens"),
                            "tokens, as serving.admit's"),
    "train.forward": ("span", ("micro",),
                      "device span: the LM train step's loss"),
    "train.backward": ("span", ("micro",),
                       "device span: the LM train step's backward, "
                       "remat's second forward included"),
    "train.update": ("span", (),
                     "device span: the LM train step's optimizer update"),
}

#: Name prefixes dynamic sites can mint beyond :data:`DYNAMIC_METRICS`
#: (trainer probe gauges mint ``train.<probe>`` per probe key).
DYNAMIC_PREFIXES = ("train.",)

#: The package whose modules are the producers.
PACKAGE = "distkeras_tpu_torch"

#: Files whose metric-name references must resolve to a producer.
CONSUMER_FILES = (
    "distkeras_tpu_torch/obs/report.py",
    "distkeras_tpu_torch/obs/slo.py",
    "scripts/obs_report.py",
    "scripts/chaos_suite.py",
    "scripts/bench_serving.py",
)

#: The instrumentation tables the warn-tier documentation rule reads.
DOC_FILE = "docs/observability.md"

# ------------------------------------------------------------------ wire config

#: HTTP server definitions: file -> protocol family.
WIRE_SERVER_FILES = {
    "distkeras_tpu_torch/serving/router.py": "engine",
    "distkeras_tpu_torch/obs/live.py": "telemetry",
}

#: HTTP client call sites: file -> protocol family the calls target.
WIRE_CLIENT_FILES = {
    "distkeras_tpu_torch/serving/router.py": "engine",
    "distkeras_tpu_torch/obs/live.py": "telemetry",
    "scripts/chaos_suite.py": "telemetry",
}

#: Server routes consumed by operators/external scrapers rather than
#: in-repo code — exempt from the served-but-never-called check and
#: flagged ``"operator": true`` in the schema.
OPERATOR_ROUTES = {
    ("telemetry", "GET /snapshot.json"),
    ("telemetry", "GET /trace/tail"),
    ("telemetry", "GET /residency"),
}

#: Methods that make a call a client-side HTTP request.
_CLIENT_CALLEES = {"_get", "_post", "urlopen", "Request"}

# -------------------------------------------------------------- resource config

#: Acquire method name -> resource family.
ACQUIRE_FAMILY = {
    "alloc": "block",
    "share_by_hash": "block",
    "acquire": "prefix",
    "pin_prefix": "pin",
    "import_blocks": "pin",
}

#: Resource family -> release method names.
RELEASE_FAMILY = {
    "block": {"free"},
    "prefix": {"release"},
    "pin": {"unpin_prefix", "unpin", "pop"},
}

#: Calls that transfer ownership of a handle passed to them: container
#: inserts (the caller's cleanup path now walks the container) and the
#: HTTP response writers (the remote peer owns the pin it was sent).
_COLLECT_METHODS = {"append", "add", "extend", "insert", "put",
                    "appendleft", "_send", "send"}

#: Calls that cannot raise mid-protocol (or whose failure modes we
#: accept): pure builtins, the obs facade (never raises by contract),
#: lock/event primitives, and pure container/string reads.
_SAFE_BUILTINS = {
    "int", "float", "str", "bool", "len", "min", "max", "abs", "sorted",
    "list", "tuple", "dict", "set", "range", "enumerate", "zip", "sum",
    "any", "all", "isinstance", "getattr", "hasattr", "repr", "format",
    "round", "id", "hex", "type", "print",
}
_SAFE_METHODS = {"get", "items", "keys", "values", "tolist", "copy",
                 "join", "split", "startswith", "endswith", "encode",
                 "decode", "format", "hexdigest", "setdefault",
                 "monotonic", "time", "perf_counter"}
_SAFE_ROOTS = {"obs", "time", "math", "os", "logging"}
_LOCKISH = ("lock", "cond", "sem", "event", "mutex", "cv")


# ----------------------------------------------------------------- AST helpers

def _str_const(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _first_arg_str(call: ast.Call) -> str | None:
    return _str_const(call.args[0]) if call.args else None


def _callee(call: ast.Call) -> str:
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return ""


def _is_metric_name(s: str) -> bool:
    return bool(NAME_RE.match(s)) and s.rsplit(".", 1)[-1] not in _FILE_EXT


def _rel(path: str, root: str) -> str:
    return os.path.relpath(path, root).replace("\\", "/")


# ============================================================ telemetry census

class EmitSite:
    """One emission site: name, instrument kind, label-key set."""

    __slots__ = ("name", "kind", "labels", "path", "line")

    def __init__(self, name, kind, labels, path, line):
        self.name, self.kind = name, kind
        self.labels = frozenset(labels)
        self.path, self.line = path, line


def _labels_of(call: ast.Call, kind: str) -> set[str]:
    """Label keys a call contributes: keyword names minus per-kind call
    parameters; ``**labels`` contributes the ``"*"`` marker."""
    out = set()
    for kw in call.keywords:
        if kw.arg is None:
            out.add("*")
        elif kw.arg not in NON_LABEL_KW[kind]:
            out.add(kw.arg)
    return out


def census_emits(source: str, path: str = "<string>") -> list[EmitSite]:
    """Every literal-name emission site in one module.

    Covers the ``obs`` facade, chained registry instruments
    (``...registry.counter("x", "h").inc(**labels)``), registry
    instruments assigned to a local and observed later in the same
    function, and the SLO engine's ``self._emit("name", ...)`` event
    hook.  Dynamic-name sites (f-strings, variables) are skipped — see
    :data:`DYNAMIC_METRICS`.
    """
    tree = ast.parse(source, filename=path)
    sites: list[EmitSite] = []
    chained_inner: set[ast.Call] = set()

    # Chained registry form first, so the inner factory call is not
    # double-counted by the assigned-form scan.
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in OBSERVER_METHODS
                and isinstance(node.func.value, ast.Call)):
            continue
        inner = node.func.value
        if not isinstance(inner.func, ast.Attribute):
            continue
        kind = REGISTRY_KINDS.get(inner.func.attr)
        name = _first_arg_str(inner)
        chain = _attr_chain(inner.func)
        if kind is None or name is None or "registry" not in chain[:-1]:
            continue
        chained_inner.add(inner)
        sites.append(EmitSite(name, kind, _labels_of(node, kind),
                              path, node.lineno))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            recv, attr = node.func.value, node.func.attr
            name = _first_arg_str(node)
            if (isinstance(recv, ast.Name) and recv.id == "obs"
                    and attr in FACADE_KINDS and name is not None):
                kind = FACADE_KINDS[attr]
                sites.append(EmitSite(name, kind, _labels_of(node, kind),
                                      path, node.lineno))
            elif (attr == "_emit" and isinstance(recv, ast.Name)
                    and recv.id == "self" and name is not None
                    and _is_metric_name(name)):
                sites.append(EmitSite(name, "event",
                                      _labels_of(node, "event"),
                                      path, node.lineno))

    # Assigned registry form: ``g = ...registry.gauge("x", "h")`` then
    # ``g.set(v, metric=..., q=...)`` later in the same function.
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        handles: dict[str, tuple[str, str, int]] = {}
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)
                    and node.value not in chained_inner):
                kind = REGISTRY_KINDS.get(node.value.func.attr)
                name = _first_arg_str(node.value)
                chain = _attr_chain(node.value.func)
                if (kind is not None and name is not None
                        and "registry" in chain[:-1]):
                    handles[node.targets[0].id] = (name, kind,
                                                   node.lineno)
        for var, (name, kind, line) in handles.items():
            labels: set[str] = set()
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in OBSERVER_METHODS
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == var):
                    labels |= _labels_of(node, kind)
            sites.append(EmitSite(name, kind, labels, path, line))

    return sites


_SCENARIO_RE = re.compile(
    r"""obs\.(count|gauge|observe|event|span)\(\s*["']([a-z0-9_.]+)["']""")


def scenario_emits(source: str) -> set[str]:
    """Names emitted by script code, including emissions embedded in
    generated-child source strings (chaos scenarios) the AST cannot
    reach — a raw-regex sweep, names only."""
    return {m.group(2) for m in _SCENARIO_RE.finditer(source)
            if _is_metric_name(m.group(2))}


def merge_census(sites) -> tuple[dict, list[Finding]]:
    """Fold sites into ``{name: {"kind", "labels"}}``; kind conflicts
    (and Prometheus-family aliasing via the ``prom_name`` ledger)
    become ``metric-collision`` errors."""
    from distkeras_tpu_torch.obs.metrics import prom_name

    census: dict[str, dict] = {}
    findings: list[Finding] = []
    first: dict[str, EmitSite] = {}
    for s in sites:
        if s.name not in census:
            census[s.name] = {"kind": s.kind, "labels": set(s.labels)}
            first[s.name] = s
            continue
        ent = census[s.name]
        if ent["kind"] != s.kind:
            findings.append(Finding(
                "metric-collision", "error", s.path, s.line,
                f"'{s.name}' emitted as {s.kind} here but as "
                f"{ent['kind']} at {first[s.name].path}:"
                f"{first[s.name].line}",
                hint="one name must map to one instrument kind — "
                     "rename one of the two"))
        else:
            ent["labels"] |= s.labels
    prom: dict[str, str] = {}
    for name, ent in sorted(census.items()):
        if ent["kind"] not in REGISTRY_KINDS.values():
            continue
        p = prom_name(name)
        if p in prom and prom[p] != name:
            s = first[name]
            findings.append(Finding(
                "metric-collision", "error", s.path, s.line,
                f"'{name}' and '{prom[p]}' both render as Prometheus "
                f"family '{p}'",
                hint="pick names that stay distinct under prom_name()"))
        prom.setdefault(p, name)
    return census, findings


# ---------------------------------------------------------- consumer references

def _is_name_lookup(expr) -> bool:
    """Does ``expr`` read a record's ``name`` field (``e["name"]`` /
    ``r.get("name")``)?  The anchor that separates metric-name string
    comparisons from ordinary string code."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Subscript):
            if _str_const(node.slice) == "name":
                return True
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and _first_arg_str(node) == "name"):
            return True
    return False


def _str_elts(node):
    if isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            s = _str_const(e)
            if s is not None:
                yield e, s
    else:
        s = _str_const(node)
        if s is not None:
            yield node, s


def consumer_refs(source: str, path: str,
                  vocab: set[str]) -> list[tuple[str, int, str]]:
    """Metric-name references a consumer module makes, as
    ``(name, line, mode)`` with mode ``"exact"`` or ``"prefix"``.

    ``vocab`` is the first-segment vocabulary of known producer names
    (``{"serving", "router", ...}``) — the noise filter that keeps file
    paths and chaos fault-site labels out of the reference set.
    """
    tree = ast.parse(source, filename=path)
    refs: list[tuple[str, int, str]] = []

    def known(s: str) -> bool:
        return _is_metric_name(s) and s.split(".", 1)[0] in vocab

    for node in ast.walk(tree):
        if isinstance(node, ast.Compare):
            sides = [node.left] + list(node.comparators)
            if any(_is_name_lookup(s) for s in sides):
                for s in sides:
                    for elt, txt in _str_elts(s):
                        if _is_metric_name(txt):
                            refs.append((txt, elt.lineno, "exact"))
        elif isinstance(node, ast.Call):
            callee = _callee(node)
            if (callee == "startswith"
                    and isinstance(node.func, ast.Attribute)
                    and _is_name_lookup(node.func.value)
                    and node.args):
                for _elt, txt in _str_elts(node.args[0]):
                    refs.append((txt, node.lineno, "prefix"))
            elif callee == "SloRule":
                txt = _first_arg_str(node)
                if txt is not None and _is_metric_name(txt):
                    refs.append((txt, node.lineno, "exact"))
            elif (isinstance(node.func, ast.Name)
                    and node.func.id in {"counter", "gauge",
                                         "histogram", "hist"}):
                txt = _first_arg_str(node)
                if txt is not None and known(txt):
                    refs.append((txt, node.lineno, "exact"))
            elif (callee == "get" and isinstance(node.func,
                                                 ast.Attribute)
                    and node.args):
                txt = _str_const(node.args[0])
                if txt is not None and known(txt):
                    refs.append((txt, node.lineno, "exact"))
        elif isinstance(node, ast.Subscript):
            txt = _str_const(node.slice)
            if txt is not None and known(txt):
                refs.append((txt, node.lineno, "exact"))
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.endswith("_METRICS")):
            for _elt, txt in _str_elts(node.value):
                if _is_metric_name(txt):
                    refs.append((txt, node.lineno, "exact"))
        elif isinstance(node, (ast.Tuple, ast.List)):
            # Only all-string literals: mixed tuples are structured
            # records (chaos fault-plan events carry site labels like
            # ("cluster.push", 5, "fail") that are NOT metric names).
            if node.elts and all(
                    isinstance(e, ast.Constant)
                    and isinstance(e.value, str) for e in node.elts):
                for elt, txt in _str_elts(node):
                    if known(txt):
                        refs.append((txt, elt.lineno, "exact"))
    return refs


def documented_names(doc_text: str) -> set[str]:
    """Dotted names the observability doc mentions (label-set suffixes
    like ``{status}`` stripped first).  A deliberate superset — extra
    dotted tokens in prose only ever make the documentation rule MORE
    permissive."""
    text = re.sub(r"\{[^}]*\}", "", doc_text)
    return set(re.findall(r"[a-z0-9_]+(?:\.[a-z0-9_]+)+", text))


# ================================================================= wire census

_SEND_CALLEES = {"_send", "_send_raw", "send_response", "send_error"}


def _status_codes(body) -> set[int]:
    out: set[int] = set()
    for stmt in body:
        for node in ast.walk(stmt):
            if (isinstance(node, ast.Call)
                    and _callee(node) in _SEND_CALLEES and node.args):
                arg = node.args[0]
                arms = (arg.body, arg.orelse) if isinstance(
                    arg, ast.IfExp) else (arg,)
                for a in arms:
                    if (isinstance(a, ast.Constant)
                            and isinstance(a.value, int)):
                        out.add(a.value)
    return out


def _branch_params(body) -> set[str]:
    """Query params a route branch reads: ``q.get("id")`` keys in a
    branch that also calls ``parse_qs``."""
    uses_qs = any(isinstance(n, ast.Call) and _callee(n) == "parse_qs"
                  for stmt in body for n in ast.walk(stmt))
    if not uses_qs:
        return set()
    out = set()
    for stmt in body:
        for node in ast.walk(stmt):
            if (isinstance(node, ast.Call) and _callee(node) == "get"
                    and isinstance(node.func, ast.Attribute)
                    and node.args):
                key = _str_const(node.args[0])
                if key is not None:
                    out.add(key)
    return out


def server_routes(source: str, path: str = "<string>") -> dict:
    """Routes one module serves: ``{"GET /poll": {"params": set,
    "status": set}}``.

    GET routes come from ``url.path == "/x"`` comparisons inside any
    ``do_GET``; POST routes from the ``{"/x": self._post_x}`` dispatch
    dict inside ``do_POST``, statuses read from each handler's body.
    """
    tree = ast.parse(source, filename=path)
    routes: dict[str, dict] = {}
    fns = {n.name: n for n in ast.walk(tree)
           if isinstance(n, ast.FunctionDef)}

    for fn in ast.walk(tree):
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name in ("do_GET", "do_POST")):
            continue
        method = fn.name.split("_")[1]
        for node in ast.walk(fn):
            if (method == "GET" and isinstance(node, ast.If)
                    and isinstance(node.test, ast.Compare)
                    and len(node.test.ops) == 1
                    and isinstance(node.test.ops[0], ast.Eq)):
                sides = [node.test.left, node.test.comparators[0]]
                lit = next((s for s in map(_str_const, sides)
                            if s is not None and s.startswith("/")),
                           None)
                anchored = any(
                    isinstance(s, ast.Attribute) and s.attr == "path"
                    for s in sides)
                if lit is not None and anchored:
                    routes[f"GET {lit}"] = {
                        "params": _branch_params(node.body),
                        "status": _status_codes(node.body)}
            elif method == "POST" and isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    lit = _str_const(k)
                    if (lit is None or not lit.startswith("/")
                            or not isinstance(v, ast.Attribute)):
                        continue
                    handler = fns.get(v.attr)
                    routes[f"POST {lit}"] = {
                        "params": set(),
                        "status": _status_codes(handler.body)
                        if handler is not None else set()}
    return routes


def client_calls(source: str, path: str = "<string>") -> list[dict]:
    """Client-side HTTP calls one module makes: ``{"route", "params",
    "expects", "line"}`` per call site.

    Routes come from ``/``-prefixed string constants (including
    f-string constant parts — ``f"/poll?id={rid}"``) in the argument
    subtree of ``_get``/``_post``/``urlopen``/``Request`` calls; status
    expectations from integer comparisons against ``code``/``status``
    names in the enclosing function.
    """
    tree = ast.parse(source, filename=path)
    out: list[dict] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        expects: set[int] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Compare):
                sides = [node.left] + list(node.comparators)
                codeish = any(
                    (isinstance(s, ast.Name)
                     and s.id in ("code", "status"))
                    or (isinstance(s, ast.Attribute)
                        and s.attr in ("code", "status"))
                    for s in sides)
                if codeish:
                    expects |= {s.value for s in sides
                                if isinstance(s, ast.Constant)
                                and isinstance(s.value, int)}
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and _callee(node) in _CLIENT_CALLEES):
                continue
            method = "POST" if _callee(node) == "_post" else "GET"
            for kw in node.keywords:
                if (kw.arg == "method"
                        and _str_const(kw.value) is not None):
                    method = _str_const(kw.value)
            parts: list[str] = []
            for arg in node.args:
                for sub in ast.walk(arg):
                    s = _str_const(sub)
                    if s is not None:
                        parts.append(s)
                    elif isinstance(sub, ast.JoinedStr):
                        parts.extend(v.value for v in sub.values
                                     if isinstance(v, ast.Constant)
                                     and isinstance(v.value, str))
            for s in parts:
                if not s.startswith("/") or s.startswith("//"):
                    continue
                route_path, sep, query = s.partition("?")
                params = ({p.split("=", 1)[0]
                           for p in query.split("&") if p}
                          if sep else set())
                out.append({"route": f"{method} {route_path}",
                            "params": params, "expects": set(expects),
                            "line": node.lineno})
    return out


def collect_wire(root: str) -> tuple[dict, dict]:
    """Census servers and clients across the configured files.

    Returns ``(servers, clients)``: ``servers[family][route] =
    {"params", "status"}``; ``clients[family][route] = {"params",
    "expects", "sites": [(path, line), ...]}``.
    """
    servers: dict[str, dict] = {}
    clients: dict[str, dict] = {}
    for rel, family in WIRE_SERVER_FILES.items():
        full = os.path.join(root, rel)
        with open(full, encoding="utf-8") as fh:
            routes = server_routes(fh.read(), rel)
        fam = servers.setdefault(family, {})
        for route, ent in routes.items():
            fam[route] = ent
    for rel, family in WIRE_CLIENT_FILES.items():
        full = os.path.join(root, rel)
        with open(full, encoding="utf-8") as fh:
            calls = client_calls(fh.read(), rel)
        fam = clients.setdefault(family, {})
        for c in calls:
            ent = fam.setdefault(c["route"], {"params": set(),
                                              "expects": set(),
                                              "sites": []})
            ent["params"] |= c["params"]
            ent["expects"] |= c["expects"]
            ent["sites"].append((rel, c["line"]))
    return servers, clients


def check_wire(servers: dict, clients: dict, pinned_wire: dict,
               schema_rel: str) -> list[Finding]:
    """Cross-check both directions and against the pinned schema."""
    findings: list[Finding] = []
    for family, fam_clients in sorted(clients.items()):
        fam_servers = servers.get(family, {})
        for route, ent in sorted(fam_clients.items()):
            rel, line = ent["sites"][0]
            if route not in fam_servers:
                findings.append(Finding(
                    "route-drift", "error", rel, line,
                    f"client calls {family} route '{route}' no server "
                    f"handles",
                    hint="add the route to the server dispatch or fix "
                         "the client path"))
                continue
            srv = fam_servers[route]
            unknown = ent["params"] - srv["params"]
            if unknown:
                findings.append(Finding(
                    "route-drift", "error", rel, line,
                    f"client sends params {sorted(unknown)} on "
                    f"'{route}' the {family} server never reads",
                    hint="sync the query-parameter names"))
            phantom = ent["expects"] - srv["status"]
            if phantom:
                findings.append(Finding(
                    "status-drift", "warn", rel, line,
                    f"client checks status {sorted(phantom)} on "
                    f"'{route}' but the {family} server only sends "
                    f"{sorted(srv['status'])}",
                    hint="dead status branch — sync the protocol"))
    for family, fam_servers in sorted(servers.items()):
        fam_clients = clients.get(family, {})
        for route in sorted(fam_servers):
            if (route not in fam_clients
                    and (family, route) not in OPERATOR_ROUTES):
                findings.append(Finding(
                    "route-drift", "error",
                    _server_file_of(family), 1,
                    f"{family} serves '{route}' but no in-repo client "
                    f"calls it and it carries no operator flag",
                    hint="delete the route or add it to "
                         "OPERATOR_ROUTES in contract_lint.py"))
    built = _wire_doc(servers, clients)
    if built != pinned_wire:
        for family in sorted(set(built) | set(pinned_wire)):
            b, p = built.get(family, {}), pinned_wire.get(family, {})
            for route in sorted(set(b) | set(p)):
                if b.get(route) != p.get(route):
                    findings.append(Finding(
                        "route-drift", "error", schema_rel, 1,
                        f"wire census for {family} '{route}' differs "
                        f"from the pinned schema: census="
                        f"{b.get(route)} pinned={p.get(route)}",
                        hint="re-record with --update-budgets and "
                             "review the protocol diff"))
    return findings


def _server_file_of(family: str) -> str:
    for rel, fam in WIRE_SERVER_FILES.items():
        if fam == family:
            return rel
    return "scripts/obs_schema.json"


def _wire_doc(servers: dict, clients: dict) -> dict:
    doc: dict[str, dict] = {}
    for family, fam in servers.items():
        d = doc.setdefault(family, {})
        for route, ent in fam.items():
            cli = clients.get(family, {}).get(route, {})
            d[route] = {
                "params": sorted(ent["params"]),
                "status": sorted(ent["status"]),
                "client_expects": sorted(cli.get("expects", ())),
                "operator": (family, route) in OPERATOR_ROUTES,
            }
    return doc


# ========================================================== resource pairing

class _Handle:
    __slots__ = ("var", "family", "recv", "line", "state",
                 "protected", "fin_depth")

    def __init__(self, var, family, recv, line):
        self.var, self.family, self.recv = var, family, recv
        self.line = line
        self.state = "held"          # held | vacuous | resolved | reported
        self.protected = 0           # depth of protecting try blocks
        self.fin_depth = 0           # of which: finally-releasing tries


def _acquire_of(node) -> tuple[str, list[str]] | None:
    """``(family, receiver_chain)`` when ``node`` is an acquire call."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)):
        return None
    fam = ACQUIRE_FAMILY.get(node.func.attr)
    if fam is None:
        return None
    chain = _attr_chain(node.func)
    recv = chain[:-1]
    if recv and any(h in recv[-1].lower() for h in _LOCKISH):
        return None
    return fam, recv


def _contains_name(expr, var: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == var
               for n in ast.walk(expr))


def _safe_call(call: ast.Call, recv: list[str]) -> bool:
    if isinstance(call.func, ast.Name):
        return call.func.id in _SAFE_BUILTINS
    chain = _attr_chain(call.func)
    if not chain:
        return False
    method, owner = chain[-1], chain[:-1]
    if chain[0] in _SAFE_ROOTS:
        return True
    if owner and owner == recv and method not in ACQUIRE_FAMILY:
        return True
    if owner and any(h in owner[-1].lower() for h in _LOCKISH):
        return True
    return method in _SAFE_METHODS or method in _COLLECT_METHODS


def _escape_occurrence(expr, var: str, recv: list[str],
                       parents=None) -> bool:
    """Does ``var`` occur in ``expr`` wrapped only by containers and
    safe conversion calls (so storing/sending ``expr`` transfers the
    handle), rather than swallowed as an argument to a fallible call?"""
    def walk(node, risky: bool) -> bool:
        if isinstance(node, ast.Name) and node.id == var:
            return not risky
        child_risky = risky
        if isinstance(node, ast.Call):
            if not (isinstance(node.func, ast.Name)
                    and node.func.id in _SAFE_BUILTINS):
                child_risky = True
        return any(walk(c, child_risky)
                   for c in ast.iter_child_nodes(node))
    return walk(expr, False)


def _is_release(call: ast.Call, h: _Handle) -> bool:
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr not in RELEASE_FAMILY[h.family]:
        return False
    if any(_contains_name(a, h.var) for a in call.args):
        return True
    return _attr_chain(call.func)[:-1] == h.recv


def _stmt_resolves(stmt, h: _Handle) -> bool:
    """Release or ownership-transfer of ``h`` in one statement."""
    if isinstance(stmt, (ast.Return, ast.Expr)) and isinstance(
            getattr(stmt, "value", None), ast.Yield):
        stmt = stmt.value  # yield treated like return below
    if isinstance(stmt, ast.Return) and stmt.value is not None:
        if _contains_name(stmt.value, h.var):
            return True
    if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        value = stmt.value
        if value is not None and any(
                isinstance(t, (ast.Attribute, ast.Subscript))
                for t in targets):
            if _escape_occurrence(value, h.var, h.recv):
                return True
    for node in ast.walk(stmt):
        if not isinstance(node, ast.Call):
            continue
        if _is_release(node, h):
            return True
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _COLLECT_METHODS
                and any(_escape_occurrence(a, h.var, h.recv)
                        for a in node.args)):
            return True
    return False


def _stmt_risky(stmt, h: _Handle) -> ast.Call | None:
    """First fallible call in ``stmt`` (excluding nested defs)."""
    for node in ast.walk(stmt):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Call) and not _safe_call(node, h.recv):
            acq = _acquire_of(node)
            if acq is not None and acq[0] == h.family:
                continue  # the acquire itself / sibling acquires
            return node
    return None


def _try_protects(stmt: ast.Try, h: _Handle) -> str | None:
    """``"finally"`` when the finalbody releases the handle's family
    (runs on EVERY exit, so it discharges the obligation outright),
    ``"handler"`` when an except-rollback does (covers exception edges
    only — the normal path must still release), else None."""
    def releases(body) -> bool:
        for s in body:
            for node in ast.walk(s):
                if isinstance(node, ast.Call) and (
                        _is_release(node, h)
                        or (isinstance(node.func, ast.Attribute)
                            and node.func.attr
                            in RELEASE_FAMILY[h.family])):
                    return True
        return False
    if releases(stmt.finalbody):
        return "finally"
    if any(releases(hd.body) for hd in stmt.handlers):
        return "handler"
    return None


def _none_test(test, var: str):
    """``var is None`` -> "none"; ``var is not None`` -> "notnone"."""
    if (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.left, ast.Name)
            and test.left.id == var
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None):
        if isinstance(test.ops[0], ast.Is):
            return "none"
        if isinstance(test.ops[0], ast.IsNot):
            return "notnone"
    return None


class _ResourceEval:
    """Evaluate one handle's lifetime over the remainder of its
    function — a tiny path-sensitive interpreter over the statement
    tree (If/Try/With/loops), tracking held/vacuous/resolved and the
    exception edges ``try`` protection covers."""

    def __init__(self, h: _Handle, path: str):
        self.h = h
        self.path = path
        self.findings: list[Finding] = []

    def _leak(self, line: int, why: str) -> None:
        if self.h.state != "reported":
            self.findings.append(Finding(
                "unbalanced-resource", "error", self.path, line,
                f"{self.h.family} handle '{self.h.var}' acquired at "
                f"line {self.h.line} {why}",
                hint="release on every path (try/finally or an "
                     "except-rollback), or hand ownership off "
                     "explicitly"))
            self.h.state = "reported"

    # -- statement-sequence walker ------------------------------------

    def _risk_expr(self, expr, line_hint: int) -> None:
        """Flag the first fallible call inside one header expression."""
        h = self.h
        if h.state != "held" or h.protected or expr is None:
            return
        for node in ast.walk(expr):
            if isinstance(node, ast.Call) and not _safe_call(node,
                                                             h.recv):
                self._leak(getattr(node, "lineno", line_hint),
                           "can leak if this call raises "
                           f"('{_callee(node)}' is on the path "
                           "before any release)")
                return

    def run_block(self, stmts, loop_depth: int) -> str:
        """Run statements; returns "fall" | "exit"."""
        h = self.h
        for stmt in stmts:
            if h.state in ("resolved", "reported"):
                return "fall"
            if isinstance(stmt, (ast.If, ast.For, ast.While, ast.With,
                                 ast.Try)):
                kind = self._compound(stmt, loop_depth)
                if kind == "exit":
                    return "exit"
                continue
            # Rebinding the handle variable loses the only reference.
            if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == h.var
                    for t in stmt.targets):
                if h.state == "held" and not _stmt_resolves(stmt, h):
                    self._leak(stmt.lineno,
                               "is overwritten before release")
                if h.state != "reported":
                    h.state = "resolved"
                return "fall"
            if h.state == "held":
                if _stmt_resolves(stmt, h):
                    h.state = "resolved"
                    return "fall"
                risky = _stmt_risky(stmt, h)
                if risky is not None and not h.protected:
                    self._leak(risky.lineno,
                               "can leak if this call raises "
                               f"('{_callee(risky)}' is on the path "
                               "before any release)")
            if isinstance(stmt, (ast.Return, ast.Raise)):
                if h.state == "held":
                    if h.fin_depth:
                        h.state = "resolved"  # finally releases on exit
                    else:
                        word = ("return" if isinstance(stmt, ast.Return)
                                else "raise")
                        self._leak(stmt.lineno,
                                   f"never released before {word}")
                return "exit"
            if isinstance(stmt, (ast.Break, ast.Continue)):
                if h.state == "held":
                    if h.fin_depth:
                        h.state = "resolved"
                    elif loop_depth == 0:
                        self._leak(stmt.lineno, "never released "
                                   "before leaving the loop")
                return "exit"
        return "fall"

    @staticmethod
    def _merge(branches) -> tuple[str, str | None]:
        """Join (kind, state) per may-fall-through path."""
        live = [s for k, s in branches if k == "fall"]
        if not live:
            return "exit", None
        for rank in ("reported", "held", "vacuous", "resolved"):
            if rank in live:
                return "fall", rank
        return "fall", live[0]

    def _compound(self, stmt, loop_depth: int) -> str:
        h = self.h
        if isinstance(stmt, ast.If):
            entry = h.state
            mode = _none_test(stmt.test, h.var)
            if mode is None:
                self._risk_expr(stmt.test, stmt.lineno)
            h.state = "vacuous" if (mode == "none"
                                    and entry == "held") else entry
            body_kind = self.run_block(stmt.body, loop_depth)
            body_state = h.state
            h.state = "vacuous" if (mode == "notnone"
                                    and entry == "held") else entry
            else_kind = (self.run_block(stmt.orelse, loop_depth)
                         if stmt.orelse else "fall")
            else_state = h.state
            # A vacuous path that falls through carries no obligation.
            if mode == "none" and entry == "held":
                body_state = ("resolved" if body_state == "vacuous"
                              else body_state)
            if mode == "notnone" and entry == "held":
                else_state = ("resolved" if else_state == "vacuous"
                              else else_state)
            kind, state = self._merge([(body_kind, body_state),
                                       (else_kind, else_state)])
            if kind == "exit":
                return "exit"
            h.state = state
            return "fall"
        if isinstance(stmt, ast.Try):
            prot = (_try_protects(stmt, h)
                    if h.state == "held" else None)
            if prot is not None:
                h.protected += 1
                if prot == "finally":
                    h.fin_depth += 1
            body_kind = self.run_block(stmt.body, loop_depth)
            if prot is not None:
                h.protected -= 1
                if prot == "finally":
                    h.fin_depth -= 1
            if prot == "finally" and h.state == "held":
                # the finalbody's release runs on fall-through too
                h.state = "resolved"
            # Handler bodies are not re-evaluated for this handle: on
            # the exception edge either the try protects (rollback /
            # finally) or the risky statement inside the body was
            # already flagged.
            if stmt.orelse and body_kind == "fall":
                body_kind = self.run_block(stmt.orelse, loop_depth)
            if stmt.finalbody:
                fin_kind = self.run_block(stmt.finalbody, loop_depth)
                if fin_kind == "exit":
                    return "exit"
            return body_kind if not stmt.handlers else "fall"
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self._risk_expr(item.context_expr,
                                stmt.lineno)
            return self.run_block(stmt.body, loop_depth)
        if isinstance(stmt, (ast.For, ast.While)):
            if isinstance(stmt, ast.For):
                self._risk_expr(stmt.iter, stmt.lineno)
            else:
                self._risk_expr(stmt.test, stmt.lineno)
            entry = h.state
            self.run_block(stmt.body, loop_depth + 1)
            # zero-trip loops: resolution inside the body is not
            # guaranteed, so the entry obligation survives the loop
            if h.state != "reported":
                h.state = entry
            self.run_block(stmt.orelse, loop_depth)
            return "fall"
        return "fall"


def _walk_resource_fn(fn, path: str) -> list[Finding]:
    findings: list[Finding] = []

    def scan(stmts, enclosing, loop_depth):
        """Find acquires in ``stmts``; ``enclosing`` is the stack of
        (remaining-statements, loop_depth, try-node-or-None) blocks to
        evaluate after the innermost block falls through."""
        for i, stmt in enumerate(stmts):
            acq = None
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Call)):
                acq = _acquire_of(stmt.value)
                if acq is not None:
                    fam, recv = acq
                    h = _Handle(stmt.targets[0].id, fam, recv,
                                stmt.lineno)
                    ev = _ResourceEval(h, path)
                    # Protection from try blocks the acquire already
                    # sits inside applies from the first statement.
                    prots = []
                    for _rest, _depth, tnode in enclosing:
                        p = (_try_protects(tnode, h)
                             if tnode is not None else None)
                        prots.append(p)
                        if p is not None:
                            h.protected += 1
                        if p == "finally":
                            h.fin_depth += 1
                    kind = ev.run_block(stmts[i + 1:], loop_depth)
                    depth_now = loop_depth
                    for (rest, depth, tnode), p in zip(
                            reversed(enclosing), reversed(prots)):
                        if kind != "fall" or h.state in ("resolved",
                                                         "reported"):
                            break
                        if p is not None:
                            h.protected -= 1
                            if p == "finally":
                                h.fin_depth -= 1
                                h.state = "resolved"
                                break
                        if depth < depth_now and h.state == "held":
                            # fell off a loop body still holding
                            ev._leak(stmt.lineno,
                                     "is not released before the "
                                     "next loop iteration")
                            break
                        kind = ev.run_block(rest, depth)
                        depth_now = depth
                    if kind == "fall" and h.state == "held":
                        ev._leak(stmt.lineno, "is never released "
                                 "before the function returns")
                    findings.extend(ev.findings)
            elif isinstance(stmt, ast.Expr) and isinstance(
                    stmt.value, ast.Call):
                a = _acquire_of(stmt.value)
                if a is not None:
                    findings.append(Finding(
                        "unbalanced-resource", "error", path,
                        stmt.lineno,
                        f"{a[0]} acquire result discarded — the "
                        "handle can never be released",
                        hint="bind the result and release it, or "
                             "drop the call"))
            # recurse into child blocks
            for body, extra_loop, tnode in _child_blocks(stmt):
                scan(body,
                     enclosing + [(stmts[i + 1:], loop_depth, tnode)],
                     loop_depth + extra_loop)

    scan(fn.body, [], 0)
    return findings


def _child_blocks(stmt):
    """(body, extra_loop_depth, enclosing_try) per child block."""
    if isinstance(stmt, ast.If):
        return [(stmt.body, 0, None), (stmt.orelse, 0, None)]
    if isinstance(stmt, (ast.For, ast.While)):
        return [(stmt.body, 1, None), (stmt.orelse, 0, None)]
    if isinstance(stmt, ast.With):
        return [(stmt.body, 0, None)]
    if isinstance(stmt, ast.Try):
        blocks = [(stmt.body, 0, stmt)]
        blocks += [(h.body, 0, None) for h in stmt.handlers]
        blocks += [(stmt.orelse, 0, None), (stmt.finalbody, 0, None)]
        return blocks
    return []


def lint_resource_source(source: str,
                         path: str = "<string>") -> list[Finding]:
    """The resource-pairing rule over one module's functions."""
    tree = ast.parse(source, filename=path)
    findings: list[Finding] = []
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            findings.extend(_walk_resource_fn(fn, path))
    lines = source.splitlines()
    out = []
    for f in findings:
        text = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        out.append(apply_suppressions(f, text))
    return out


def lint_resource_paths(paths) -> list[Finding]:
    findings: list[Finding] = []
    for f in iter_py_files(paths):
        with open(f, encoding="utf-8") as fh:
            findings.extend(lint_resource_source(fh.read(), path=f))
    return findings


# ================================================================ schema + lint

def _producer_files(root: str) -> list[str]:
    return iter_py_files([os.path.join(root, PACKAGE)])


def _script_files(root: str) -> list[str]:
    return iter_py_files([os.path.join(root, "scripts")])


def collect_telemetry(root: str):
    """``(sites, census, collision_findings, scenario_names)`` for the
    whole repo, with suppression comments honoured at emission sites."""
    sites: list[EmitSite] = []
    for f in _producer_files(root):
        with open(f, encoding="utf-8") as fh:
            sites.extend(census_emits(fh.read(), _rel(f, root)))
    scenario: set[str] = set()
    for f in _script_files(root):
        with open(f, encoding="utf-8") as fh:
            scenario |= scenario_emits(fh.read())
    census, collisions = merge_census(sites)
    return sites, census, collisions, scenario


def build_obs_schema(root: str) -> dict:
    """The pinnable contract document (no findings — pure census)."""
    _sites, census, _coll, scenario = collect_telemetry(root)
    servers, clients = collect_wire(root)
    return {
        "metrics": {name: {"kind": ent["kind"],
                           "labels": sorted(ent["labels"])}
                    for name, ent in sorted(census.items())},
        "dynamic_metrics": sorted(DYNAMIC_METRICS),
        "scenario_events": sorted(scenario),
        "wire": _wire_doc(servers, clients),
    }


def save_obs_schema(path: str, schema: dict) -> None:
    doc = {"comment": "Pinned telemetry + wire-protocol contract "
                      "census. Regenerate with scripts/graph_lint.py "
                      "--update-budgets and review the diff like a "
                      "code change.",
           **schema}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def load_obs_schema(path: str) -> dict | None:
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    doc.pop("comment", None)
    return doc


def check_obs_schema(built: dict, pinned: dict | None,
                     schema_rel: str = "scripts/obs_schema.json",
                     sites: dict | None = None) -> list[Finding]:
    """Census-vs-schema comparison (telemetry half).  ``sites`` maps
    metric name -> (path, line) for error placement at the emitting
    site when available."""
    sites = sites or {}
    findings: list[Finding] = []
    if pinned is None:
        return [Finding(
            "metric-drift", "error", schema_rel, 1,
            "no telemetry schema recorded for this repo",
            hint="run scripts/graph_lint.py --update-budgets to pin "
                 "the contract census")]
    want = {n: v for n, v in pinned.get("metrics", {}).items()
            if n not in NOT_EMITTED}
    want.update({n: {"kind": kind, "labels": sorted(labels)}
                 for n, (kind, labels, _why) in PORT_ONLY.items()})
    got = built.get("metrics", {})
    for name in sorted(set(got) | set(want)):
        path, line = sites.get(name, (schema_rel, 1))
        if name not in want:
            findings.append(Finding(
                "metric-drift", "error", path, line,
                f"'{name}' is emitted but not pinned in the schema",
                hint="re-record with --update-budgets and review the "
                     "contract diff"))
        elif name not in got:
            findings.append(Finding(
                "metric-drift", "error", schema_rel, 1,
                f"'{name}' is pinned in the schema but no longer "
                f"emitted",
                hint="a consumer may still read it — re-record with "
                     "--update-budgets after checking consumers"))
        elif want[name]["kind"] != got[name]["kind"]:
            findings.append(Finding(
                "metric-drift", "error", path, line,
                f"'{name}' changed instrument kind: "
                f"{want[name]['kind']} -> {got[name]['kind']}",
                hint="consumers bound to the old kind — re-record "
                     "with --update-budgets"))
        elif want[name]["labels"] != got[name]["labels"]:
            findings.append(Finding(
                "label-drift", "error", path, line,
                f"'{name}' label keys drifted: pinned "
                f"{want[name]['labels']} vs emitted "
                f"{got[name]['labels']}",
                hint="label-key changes re-key every aggregation — "
                     "re-record with --update-budgets"))
    for key in ("dynamic_metrics", "scenario_events"):
        if sorted(built.get(key, [])) != sorted(pinned.get(key, [])):
            findings.append(Finding(
                "metric-drift", "error", schema_rel, 1,
                f"schema section '{key}' drifted from the census",
                hint="re-record with --update-budgets"))
    return findings


def lint_repo_contracts(root: str,
                        schema_path: str | None = None) -> list[Finding]:
    """The full contract gate: telemetry census vs schema, consumer
    resolution, documentation coverage, wire-protocol cross-check, and
    the resource-pairing analysis over ``serving/``."""
    if schema_path is None:
        schema_path = os.path.join(root, "scripts", "obs_schema.json")
    schema_rel = _rel(schema_path, root)
    findings: list[Finding] = []

    sites, census, collisions, scenario = collect_telemetry(root)
    findings.extend(collisions)

    pinned = load_obs_schema(schema_path)
    built = {
        "metrics": {n: {"kind": e["kind"], "labels": sorted(e["labels"])}
                    for n, e in census.items()},
        "dynamic_metrics": sorted(DYNAMIC_METRICS),
        "scenario_events": sorted(scenario),
    }
    site_index = {}
    for s in sites:
        site_index.setdefault(s.name, (s.path, s.line))
    findings.extend(check_obs_schema(built, pinned, schema_rel,
                                     site_index))

    # -- consumer resolution ------------------------------------------
    producers = set(census) | set(DYNAMIC_METRICS) | scenario
    vocab = {n.split(".", 1)[0] for n in producers}
    for rel in CONSUMER_FILES:
        full = os.path.join(root, rel)
        if not os.path.exists(full):
            continue
        with open(full, encoding="utf-8") as fh:
            src = fh.read()
        src_lines = src.splitlines()
        for name, line, mode in consumer_refs(src, rel, vocab):
            if mode == "exact":
                ok = (name in producers
                      or any(name.startswith(p)
                             for p in DYNAMIC_PREFIXES))
            else:
                ok = any(p == name or p.startswith(name)
                         for p in producers)
            if not ok:
                f = Finding(
                    "dangling-consumer", "error", rel, line,
                    f"consumer references "
                    f"{'prefix' if mode == 'prefix' else 'name'} "
                    f"'{name}' that no producer emits",
                    hint="rename the reference to a live metric or "
                         "delete the dead consumer path")
                text = (src_lines[line - 1]
                        if 0 < line <= len(src_lines) else "")
                findings.append(apply_suppressions(f, text))

    # -- documentation coverage (warn, baselineable) ------------------
    doc_full = os.path.join(root, DOC_FILE)
    documented: set[str] = set()
    if os.path.exists(doc_full):
        with open(doc_full, encoding="utf-8") as fh:
            documented = documented_names(fh.read())
    # The reference's doc covers the shared names; a port-only name is
    # documented by its PORT_ONLY reason.
    documented |= set(PORT_ONLY)
    for name in sorted(census):
        if name not in documented:
            path, line = site_index.get(name, (schema_rel, 1))
            findings.append(Finding(
                "undocumented-metric", "warn", path, line,
                f"'{name}' is emitted but absent from the "
                f"{DOC_FILE} instrumentation tables",
                hint="add it to the layer table (or baseline with "
                     "--update-baseline while docs catch up)"))

    # -- wire protocol ------------------------------------------------
    servers, clients = collect_wire(root)
    pinned_wire = (pinned or {}).get("wire", {})
    findings.extend(check_wire(servers, clients, pinned_wire,
                               schema_rel))

    # -- resource pairing ---------------------------------------------
    serving_dir = os.path.join(root, PACKAGE, "serving")
    for f in lint_resource_paths([serving_dir]):
        # iter_py_files prefixes every path with ``root`` (absolute or
        # relative), so the findings always re-anchor cleanly.
        findings.append(Finding(f.rule, f.severity, _rel(f.path, root),
                                f.line, f.message, f.hint,
                                f.suppressed, f.baselined))
    return findings


__all__ = [
    "DYNAMIC_METRICS", "NOT_EMITTED", "OPERATOR_ROUTES", "PORT_ONLY",
    "EmitSite",
    "census_emits", "scenario_emits", "merge_census", "consumer_refs",
    "documented_names", "server_routes", "client_calls", "collect_wire",
    "check_wire", "lint_resource_source", "lint_resource_paths",
    "collect_telemetry", "build_obs_schema", "save_obs_schema",
    "load_obs_schema", "check_obs_schema", "lint_repo_contracts",
]
