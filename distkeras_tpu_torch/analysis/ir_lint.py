"""Step census: audit one REAL step of the port's trainers and engines.

The port's counterpart of ``distkeras_tpu/analysis/ir_lint.py``.  The
reference traces each step to a jaxpr and compiles it to HLO; eager
torch has neither, so the port audits what one step DISPATCHES: a
:class:`TraceSpec` names the step callable the subsystem executes (the
``traced_for_analysis()`` hooks hand these out) with its state and
inputs, and :func:`trace_target` runs it once under a recording
``TorchDispatchMode``.  Every ATen op and every ``c10d`` collective the
step dispatches — in the forward, in autograd's backward, in the optimizer
— passes through the mode.  From the record:

* :func:`comm_census` — the collectives, each with its kind, payload
  dtype, payload bytes and group size (aggregated by kind), the number
  the port's ``analysis/comm_budget.json`` pins;
* ``dtype-f64`` (error) — an op that produces an f64 value;
* ``dtype-upcast`` (warn) — a bf16/f16 -> f32 copy (``_to_copy``)
  whose value reaches non-reduction math (an f32 accumulation of a
  low-precision value is the intended upcast; an operand upcast doubles
  the bytes the step moves);
* ``host-sync`` (error) — ``aten._local_scalar_dense`` (``.item()``,
  ``int(t)``, ``if t:``) or a device-to-host copy inside a step that
  must have none (``TraceSpec.host_sync_free``: the engines' decode
  window);
* ``global-generator`` (error) — a sampling op (``bernoulli``,
  ``normal_``, ``multinomial``, ``randperm``, dropout, ...) drawn
  without an explicit ``generator=``: a draw from the process-global
  stream, which no checkpoint carries and no other rank reproduces.

Steps run at world ``n`` in ONE process on torch's fake process group
(:func:`fake_world`): the group hallucinates every collective, so the
recorder gives each one the result a world of identical ranks would
give — an all-gather repeats the local shard, a sum all-reduce or
reduce-scatter scales by ``n`` — and steps that index by a gathered
value (MoE's id gather, the paged tables) see defined values.  The
census also reads ``ops.attention.LAUNCHES``: which hand kernels the
step launched (on the card; the CPU runs the plain versions).

Wire model (ring algorithms, group size n): all-reduce moves
``2(n-1)/n * payload`` per rank, reduce-scatter and all-gather
``(n-1)/n * payload``, a broadcast ``payload``.  So the ZeRO claim is
checkable: RS(G) + AG(G) == AR(G) exactly.

The reference's donation rules have no counterpart (the port's steps
update their state in place, so no buffer is donated), and neither has
its HLO reading (:data:`NOT_PORTED_RULES`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from distkeras_tpu_torch.analysis.findings import Finding

#: The reference's census rules with no port counterpart.
NOT_PORTED_RULES = {
    "donation-unused": "the port's steps update their state in place: "
                       "no buffer is donated, so none can go unconsumed",
    "donation-read": "the port's steps update their state in place: "
                     "no donated input is copied back",
}

#: Reference rule -> the port rule that takes its place.
RENAMED_RULES = {
    "host-callback": ("host-sync",),
    "prng-reuse": ("global-generator",),
}

_DTYPE_SHORT = {
    torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int8: "s8", torch.int16: "s16",
    torch.int32: "s32", torch.int64: "s64", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}

# c10d op (dispatched name) -> canonical collective kind.
_C10D_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast_": "broadcast",
    "reduce_": "reduce",
    "gather_": "gather",
    "scatter_": "scatter",
    "send": "send",
    "recv_": "recv",
    "barrier": "barrier",
}

# ReduceOp values (c10d's RedOpType).
_SUM, _AVG = 0, 1

# Ops whose f32 output of a low-precision input is an accumulation.
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "norm", "linalg_vector_norm", "var", "std", "var_mean", "std_mean",
    "logsumexp", "prod", "cumsum",
}
# Ops that only move or view their input (an upcast's value passes
# through them to whatever reads it next).
_PASS_THROUGH = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "unsqueeze", "squeeze", "select", "slice", "contiguous",
    "clone", "detach", "alias", "as_strided", "index_select", "gather",
    "narrow", "split", "split_with_sizes", "unbind", "flatten",
}

# Sampling ops: each draws from a generator.
_SAMPLERS = {
    "bernoulli", "bernoulli_", "normal", "normal_", "uniform_",
    "multinomial", "randperm", "rand", "randn", "randint", "rand_like",
    "randn_like", "randint_like", "exponential_", "geometric_",
    "cauchy_", "log_normal_", "random_", "poisson", "native_dropout",
    "_fused_dropout", "binomial", "_standard_gamma", "_sample_dirichlet",
}


# ------------------------------------------------------------------ specs


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """One step the census runs.

    ``fn`` is the *real* step callable the subsystem executes (the
    ``traced_for_analysis()`` hooks hand these out — built by the same
    construction ``train`` / ``step`` uses), and ``args`` its state and
    inputs: ``fn(*args)`` is one step.  Running it updates that state
    in place, as a ``train`` round does.  ``suppress`` is the census's
    ignore syntax: rule ids waived for this target.
    """

    name: str
    fn: Callable
    args: tuple = ()
    suppress: tuple = ()
    # Total parameter bytes of the model this step trains (the hooks
    # fill it in) — the zero parity check's reference volume P.
    params_bytes: int | None = None
    # Process-group size of each mesh axis above 1 ({} at world 1).
    group_sizes: dict = dataclasses.field(default_factory=dict)
    # The DP partner target whose gradient all-reduce this target's
    # scatter + gather exchange must replace at equal volume.
    zero1_parity_with: str | None = None
    # Which ZeRO stage's exchange to measure (1: the post-backward RS
    # + update AG; 2: the per-microbatch accumulator RS + update AG; 3:
    # the gather-on-use AG + backward grad RS, per microbatch).
    zero_stage: int = 1
    # Microbatches (accumulation depth) one step runs.
    window: int = 1
    # A step that must read nothing back to the host (the decode
    # window): any host read is a ``host-sync`` error.
    host_sync_free: bool = False
    # The persistent tensors the step carries, by kind ("params",
    # "opt", "kv", ...), for the placement census (shard_lint.py), and
    # each parameter leaf's placement spec, by leaf name.
    state: Any = None
    placements: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective of the recorded step (aggregated by kind).

    ``op`` is the c10d op as dispatched (``allreduce_``,
    ``_allgather_base_``, ...), ``canonical`` its kind; ``dtype`` the
    payload's element type ("f32", "s8", "bf16", ... — recording it
    makes the budget PROVE a compressed exchange carries int8, not the
    f32 it replaced).  ``payload_bytes``: the reduced tensor for an
    all-reduce, the full gathered tensor for an all-gather, the full
    pre-scatter operand for a reduce-scatter."""

    op: str
    canonical: str
    payload_bytes: int
    group_size: int
    count: int = 1
    dtype: str = "f32"

    @property
    def wire_bytes(self) -> float:
        """Ring-model per-rank wire bytes for ``count`` ops."""
        n = max(self.group_size, 1)
        per = {
            "all-reduce": 2 * (n - 1) / n * self.payload_bytes,
            "reduce-scatter": (n - 1) / n * self.payload_bytes,
            "all-gather": (n - 1) / n * self.payload_bytes,
            "all-to-all": (n - 1) / n * self.payload_bytes,
        }.get(self.canonical, float(self.payload_bytes))
        return per * self.count

    def as_json(self) -> dict:
        return {"op": self.op, "canonical": self.canonical,
                "dtype": self.dtype,
                "payload_bytes": self.payload_bytes,
                "group_size": self.group_size, "count": self.count,
                "wire_bytes": round(self.wire_bytes, 1)}


@dataclasses.dataclass(frozen=True)
class TraceArtifacts:
    """One recorded step: the ops it dispatched (name -> count), its
    collectives in the order they ran (``(op, canonical, payload_bytes,
    group_size, dtype)``), the rule events the recorder saw, the hand
    kernels it launched (``ops.attention.LAUNCHES`` deltas), the step's
    output and its wall time (host clock, the card synchronized)."""

    ops: dict
    collectives: tuple
    events: tuple
    launches: dict
    output: Any = None
    seconds: float = 0.0


# -------------------------------------------------------------- recorder


def _short(dtype) -> str:
    return _DTYPE_SHORT.get(dtype, str(dtype).replace("torch.", ""))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _group_of(args):
    from torch._C._distributed_c10d import ProcessGroup

    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                pg = ProcessGroup.unbox(a)
            except Exception:  # noqa: BLE001 — not a process group
                continue
            return pg.size(), pg.rank()
    return 1, 0


def _reduce_op(args) -> int | None:
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return int(a.op())
            except Exception:  # noqa: BLE001 — not a ReduceOp
                continue
    return None


def _payload(kind: str, args) -> tuple[int, str]:
    """(payload bytes, dtype) of one collective's arguments."""
    first = args[0]
    if kind == "reduce-scatter":
        src = list(_tensors(args[1]))
    elif kind == "all-gather" and isinstance(first, torch.Tensor):
        src = [first]                 # the gathered output
    elif kind == "all-gather":
        src = list(_tensors(args[0]))  # the list of outputs
    else:
        src = list(_tensors(first))
    nbytes = sum(t.numel() * t.element_size() for t in src)
    dtypes = []
    for t in src:
        s = _short(t.dtype)
        if s not in dtypes:
            dtypes.append(s)
    return nbytes, "+".join(dtypes) or "?"


def _identical_ranks(name: str, args, n: int, rank: int) -> None:
    """Give a hallucinated collective the result ``n`` identical ranks
    would produce (the fake group leaves outputs as they were)."""
    op = _reduce_op(args)
    scale = n if op in (_SUM, None) else 1
    with torch.no_grad():
        if name in ("allreduce_", "allreduce_coalesced_"):
            if op == _SUM and n > 1:
                for t in _tensors(args[0]):
                    t.mul_(n)
        elif name == "_allgather_base_":
            out, inp = args[0], args[1]
            out.view(n, -1).copy_(inp.reshape(1, -1).expand(n, -1))
        elif name == "allgather_":
            inp = list(_tensors(args[1]))
            for outs, src in zip(args[0], inp):
                for o in outs:
                    o.copy_(src)
        elif name == "_reduce_scatter_base_":
            out, inp = args[0], args[1]
            row = inp.reshape(n, -1)[rank].reshape(out.shape)
            out.copy_(row * scale if scale != 1 else row)
        elif name == "reduce_scatter_":
            for o, ins in zip(args[0], args[1]):
                src = ins[rank]
                o.copy_(src * scale if scale != 1 else src)
        elif name == "alltoall_base_":
            out, inp = args[0], args[1]
            out.view(n, -1).copy_(
                inp.reshape(n, -1)[rank].reshape(1, -1).expand(n, -1))


class _Recorder(TorchDispatchMode):
    """Records every op one step dispatches (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.ops: dict[str, int] = {}
        self.collectives: list[tuple] = []
        self.events: list[tuple] = []
        # id -> (tensor, op) of bf16/f16 -> f32 copies not yet read.
        self._upcasts: dict[int, tuple] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket.__name__
        if func.namespace == "c10d":
            kind = _C10D_KINDS.get(packet, packet)
            n, rank = _group_of(args)
            nbytes, dtype = _payload(kind, args)
            out = func(*args, **kwargs)
            _identical_ranks(packet, args, n, rank)
            self.collectives.append((packet, kind, nbytes, n, dtype))
            return out
        name = f"{func.namespace}.{packet}"
        self.ops[name] = self.ops.get(name, 0) + 1
        upcast = self._upcast_reads(args, kwargs)
        if packet in _SAMPLERS and not any(
                isinstance(v, torch.Generator)
                for v in list(args) + list(kwargs.values())):
            self.events.append(("global-generator", name))
        if packet == "_local_scalar_dense":
            self.events.append(("host-sync", name))
        out = func(*args, **kwargs)
        if upcast is not None and packet not in _REDUCTIONS:
            if packet in _PASS_THROUGH:
                # A view or move of the upcast value: its readers decide.
                for t in _tensors(out):
                    self._upcasts[id(t)] = (t, upcast)
            else:
                self.events.append(("dtype-upcast",
                                    f"{upcast} read by {packet}"))
        if packet in ("_to_copy", "copy_"):
            self._check_copy(packet, args, kwargs, out)
        for t in _tensors(out):
            if t.dtype in (torch.float64, torch.complex128):
                self.events.append(("dtype-f64", name))
                break
        return out

    def _check_copy(self, packet, args, kwargs, out) -> None:
        src = args[1] if packet == "copy_" else args[0]
        dst = out if packet == "_to_copy" else args[0]
        if not (isinstance(src, torch.Tensor)
                and isinstance(dst, torch.Tensor)):
            return
        if src.device.type != "cpu" and dst.device.type == "cpu":
            self.events.append(("host-sync", f"device-to-host {packet}"))
        if (packet == "_to_copy"
                and src.dtype in (torch.bfloat16, torch.float16)
                and dst.dtype in (torch.float32, torch.float64)):
            self._upcasts[id(dst)] = (dst, f"{_short(src.dtype)} -> "
                                           f"{_short(dst.dtype)}")

    def _upcast_reads(self, args, kwargs) -> str | None:
        """The label of a bf16/f16 -> f32 copy this op reads (each copy
        is followed to its first readers only), or None."""
        if not self._upcasts:
            return None
        label = None
        for t in _tensors((args, kwargs)):
            hit = self._upcasts.get(id(t))
            if hit is not None and hit[0] is t:
                del self._upcasts[id(t)]
                label = hit[1]
        return label


def _launch_counts() -> dict:
    from distkeras_tpu_torch.ops import attention

    return dict(attention.LAUNCHES)


# ------------------------------------------------------------ fake world


@contextlib.contextmanager
def fake_world(n: int):
    """Torch's fake process group at world ``n`` in this one process, as
    rank 0 (it hallucinates every collective).  Destroyed on exit, so it leaves
    nothing behind for the rest of the process; refuses to replace an
    initialized group."""
    if dist.is_initialized():
        raise RuntimeError(
            "fake_world needs a process with no process group: the fake "
            "group would replace the live one")
    # Importing the module registers the "fake" backend.
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ entrypoint


def trace_target(spec: TraceSpec) -> TraceArtifacts:
    """Run ``spec``'s step once under the recorder (a real step: its
    state is updated in place).  The hand-kernel launches are the
    ``ops.attention.LAUNCHES`` deltas across the run."""
    before = _launch_counts()
    rec = _Recorder()
    sync = torch.cuda.is_available() and torch.cuda.is_initialized()
    t0 = time.perf_counter()
    with rec:
        out = spec.fn(*spec.args)
    if sync:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = _launch_counts()
    launches = {k: after.get(k, 0) - before.get(k, 0) for k in after
                if after.get(k, 0) != before.get(k, 0)}
    return TraceArtifacts(ops=dict(sorted(rec.ops.items())),
                          collectives=tuple(rec.collectives),
                          events=tuple(rec.events), launches=launches,
                          output=out, seconds=seconds)


def comm_census(artifacts: TraceArtifacts) -> list[CollectiveOp]:
    """The recorded step's collectives, aggregated by (op, kind,
    payload, group, dtype), order-stable."""
    agg: dict[tuple, int] = {}
    for op, kind, nbytes, n, dtype in artifacts.collectives:
        key = (op, kind, nbytes, n, dtype)
        agg[key] = agg.get(key, 0) + 1
    return [CollectiveOp(op=k[0], canonical=k[1], payload_bytes=k[2],
                         group_size=k[3], dtype=k[4], count=v)
            for k, v in sorted(agg.items())]


def census_wire_total(census: Sequence[CollectiveOp]) -> float:
    return round(sum(c.wire_bytes for c in census), 1)


_RULES = {
    "dtype-f64": ("error", "f64 value produced by `{}`",
                  "the dtype policy is f32/bf16 compute; a .double() or "
                  "an f64 numpy constant usually causes this"),
    "dtype-upcast": ("warn", "silent {} in the step",
                     "on a low-precision path an operand upcast doubles "
                     "the bytes the step moves; cast where precision is "
                     "required and keep the rest low-precision"),
    "host-sync": ("error", "host read `{}` inside a step that must read "
                           "nothing back",
                  "each read waits for the device; keep the value on the "
                  "device and read it once after the window"),
    "global-generator": ("error", "`{}` draws from the global generator",
                         "pass an explicit torch.Generator: the global "
                         "stream is shared, unseeded per step and carried "
                         "by no checkpoint"),
}


def _audit(spec: TraceSpec, art: TraceArtifacts) -> list[Finding]:
    """One finding per (rule, target): the distinct sites in its
    message."""
    sites: dict[str, list] = {}
    for rule, what in art.events:
        if rule == "host-sync" and not spec.host_sync_free:
            continue
        if what not in sites.setdefault(rule, []):
            sites[rule].append(what)
    findings = []
    for rule, whats in sites.items():
        sev, msg, hint = _RULES[rule]
        findings.append(Finding(
            rule=rule, severity=sev, path=spec.name, line=None,
            message=msg.format("; ".join(whats)), hint=hint,
            suppressed=rule in spec.suppress))
    return findings


def lint_trace(spec: TraceSpec, artifacts: TraceArtifacts | None = None
               ) -> tuple[list[Finding], list[CollectiveOp]]:
    """Every census rule on one target: (findings, collective census).
    Pass ``artifacts`` (from :func:`trace_target`) to reuse a recorded
    step; otherwise the step runs here."""
    art = artifacts if artifacts is not None else trace_target(spec)
    return _audit(spec, art), comm_census(art)


# ------------------------------------------------------------ budgets


def census_to_budget(census: Sequence[CollectiveOp]) -> dict:
    return {"collectives": [c.as_json() for c in census],
            "wire_total": census_wire_total(census)}


def check_budget(name: str, census: Sequence[CollectiveOp],
                 budgets: dict) -> list[Finding]:
    """Compare one target's census against the checked-in budget.  Any
    drift — new ops, missing ops, changed bytes — is a finding;
    re-record deliberate changes with ``python -m
    distkeras_tpu_torch.analysis --update-budgets`` and review the
    JSON diff."""
    entry = budgets.get(name)
    if entry is None:
        return [Finding(
            rule="comm-budget", severity="error", path=name, line=None,
            message="no communication budget recorded for this target",
            hint="run python -m distkeras_tpu_torch.analysis "
                 "--update-budgets")]
    got = census_to_budget(census)
    want = {"collectives": entry.get("collectives", []),
            "wire_total": entry.get("wire_total")}
    if got == want:
        return []
    return [Finding(
        rule="comm-budget", severity="error", path=name, line=None,
        message=(f"collective census drifted from the budget: expected "
                 f"{want['wire_total']} wire bytes "
                 f"({len(want['collectives'])} op kinds), recorded "
                 f"{got['wire_total']} wire bytes "
                 f"({len(got['collectives'])} op kinds)"),
        hint="if the change is intentional, re-record with python -m "
             "distkeras_tpu_torch.analysis --update-budgets and review "
             "the analysis/comm_budget.json diff")]


def declared_zero_exchange(spec: TraceSpec, artifacts: TraceArtifacts
                           ) -> dict:
    """The ZeRO exchange one recorded step carries, per microbatch
    occurrence where the stage exchanges per microbatch: stage 1's
    reduce-scatter and update all-gather per step; stage 2's
    accumulator reduce-scatters per microbatch and its update
    all-gather per step; stage 3's gather-on-use all-gathers and
    backward reduce-scatters per microbatch (no update gather)."""
    stage = spec.zero_stage
    rs = sum(b for _, k, b, _, _ in artifacts.collectives
             if k == "reduce-scatter")
    ag = sum(b for _, k, b, _, _ in artifacts.collectives
             if k == "all-gather")
    w = max(spec.window, 1)
    if stage >= 2:
        rs //= w
    if stage >= 3:
        ag //= w
    return {"rs_bytes": rs, "ag_bytes": ag}


def check_zero1_parity(z_spec: TraceSpec, z_art: TraceArtifacts,
                       dp_census) -> list[Finding]:
    """The ZeRO acceptance check (stages 1/2/3): with P the model's
    parameter bytes, the stage's recorded scatter and gather payloads
    are each exactly P per occurrence (pad-free buckets), so by the
    ring identity RS(P) + AG(P) carries AR(P)'s wire bytes; and the DP
    partner's gradient all-reduces carry P — more is a
    ``comm-redundant-ar`` warning (a gradient reduced twice, e.g. a
    tied embedding's two contributions exchanged separately)."""
    findings = []
    P = z_spec.params_bytes

    def add(rule, severity, message, hint=""):
        findings.append(Finding(
            rule=rule, severity=severity, path=z_spec.name, line=None,
            message=message, hint=hint,
            suppressed=rule in z_spec.suppress))

    if not P:
        add("zero1-parity", "error",
            "zero parity target carries no params_bytes reference",
            "the traced_for_analysis hook must fill params_bytes")
        return findings
    decl = declared_zero_exchange(z_spec, z_art)
    stage = z_spec.zero_stage
    if decl["rs_bytes"] != P or decl["ag_bytes"] != P:
        add("zero1-parity", "error",
            f"recorded stage-{stage} exchange scatter="
            f"{decl['rs_bytes']} / gather={decl['ag_bytes']} bytes != "
            f"parameter bytes {P} — the exchange no longer carries "
            "exactly the volume the proof pins",
            "nonzero bucket padding (a leaf size stopped dividing by "
            "the data axis) or an extra exchange; inspect "
            "collectives.Zero1Layout for this parameter tree")
    findings += check_dp_volume(z_spec.name, P, dp_census,
                                z_spec.suppress)
    return findings


def dp_gradient_bytes(dp_census) -> int:
    """The DP partner's gradient all-reduce bytes: every all-reduce big
    enough to be a gradient bucket (scalars, like a loss mean, are
    bookkeeping)."""
    return sum(c.payload_bytes * c.count for c in dp_census
               if c.canonical == "all-reduce" and c.payload_bytes > 8)


def check_dp_volume(name: str, P: int, dp_census,
                    suppress: tuple = ()) -> list[Finding]:
    """The DP partner's gradient all-reduces move exactly ``P`` bytes:
    fewer is an error (some leaves are not exchanged), more a
    ``comm-redundant-ar`` warning."""
    dp_grad = dp_gradient_bytes(dp_census)
    if dp_grad < P:
        return [Finding(
            "zero1-parity", "error", name, None,
            f"DP partner all-reduces only {dp_grad} gradient bytes for "
            f"{P} parameter bytes — some leaves are not exchanged",
            suppressed="zero1-parity" in suppress)]
    if dp_grad > P:
        return [Finding(
            "comm-redundant-ar", "warn", name, None,
            f"replicated-DP all-reduces {dp_grad} bytes for {P} "
            f"parameter bytes ({dp_grad - P} redundant)",
            "usually tied weights whose gradient contributions are "
            "reduced separately instead of summed locally first",
            suppressed="comm-redundant-ar" in suppress)]
    return []


def load_budgets(path: str) -> dict:
    with open(path) as f:
        return json.load(f)["targets"]


def save_budgets(path: str, budgets: dict, world: int = 8) -> None:
    doc = {
        "comment": "per-step collective census (payload / wire bytes per "
                   "rank, ring model) of one real step per target, "
                   f"recorded at world {world} in one process on torch's "
                   "fake process group (each collective given the result "
                   "of identical ranks); the port's own transports, not "
                   "GSPMD's. Re-record with python -m "
                   "distkeras_tpu_torch.analysis --update-budgets and "
                   "review the diff",
        "world": world,
        "targets": budgets,
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


BUDGET_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "comm_budget.json")


__all__ = ["TraceSpec", "CollectiveOp", "TraceArtifacts", "fake_world",
           "trace_target", "comm_census", "lint_trace",
           "census_wire_total", "census_to_budget", "check_budget",
           "declared_zero_exchange", "check_zero1_parity",
           "dp_gradient_bytes", "check_dp_volume", "load_budgets",
           "save_budgets", "BUDGET_PATH"]
