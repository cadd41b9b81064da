"""Fleet serving: a cache-aware router over N engine replicas.

The port's copy of ``distkeras_tpu/serving/router.py``.  One
``ContinuousBatcher`` / ``PagedBatcher`` serves one process; this module
is the layer above it: a host-side :class:`Router` that fronts N engine
replicas — in-process objects or cross-host endpoints discovered over
the ``DKT_CLUSTER_*`` substrate — behind the familiar
``submit``/``enqueue``/``poll``/``drain``/``shutdown`` surface.  Four
pillars:

- **Cache-aware routing.**  The router keeps a per-replica affinity
  table of resident paged stem digests and prefix-pool ids, built
  from the replicas' residency digests (``engine.residency()`` /
  the ``/residency`` endpoint — ground truth) plus optimistic inserts
  from routed request history.  A request whose warm-prompt stems are
  resident on replica k routes to k (the same locality trick
  production LLM gateways use: a stem hit refcounts blocks instead of
  re-prefilling them); everything else falls back to least-loaded by
  the live queue-depth/lanes-busy signals, with ``slo.breach``
  subscriber callbacks demoting a breaching replica for a cooldown.
- **Health-gated membership.**  Replicas join and leave off health
  probes (``/healthz``, heartbeat freshness, or any injected
  callable).  A replica that stops answering is marked DOWN within
  one health interval and takes no new routes; when it answers again
  it rejoins under a new route epoch with a fresh affinity entry (its
  cache died with it).  ``QueueFull`` from one replica spills to the
  next candidate — the caller sees QueueFull only when every live
  replica is saturated.
- **Drain-and-reroute.**  A dead or draining replica's un-finished
  ACCEPTED requests are re-admitted elsewhere, idempotently by
  request id: the router polls only a request's CURRENT assignment,
  stamps every route with the route epoch (the same
  generation-counter idea as ``resilience/cluster.py``'s
  :class:`~distkeras_tpu_torch.resilience.cluster.EpochStore`), and records
  only the first terminal result — so a replica kill costs latency
  (the re-prefill on the new replica), never a caller-visible loss.
- **Trace propagation.**  The router assigns fleet-wide request ids
  and emits ``router.submit`` / ``router.route`` /
  ``router.reroute`` / ``router.finish`` events carrying them; each
  route event also records the replica-local request id, so
  ``obs.report.request_waterfall`` stitches the full cross-process
  waterfall — routing decision, re-route hop, and the engine-side
  admit/emit/finish stages — from the merged traces.
- **Disaggregated prefill/decode**.  Replica handles
  carry a ``role=`` label: a ``"prefill"``-specialized replica takes
  no decode routes; instead, a long-prompt request becomes a 2-stage
  hop — the router asks a prefill replica to build the warm prompt's
  KV blocks (``export_blocks`` / ``POST /prefill``), ships them to
  the chosen decode replica (``import_blocks`` / ``POST /blocks`` —
  the :mod:`~distkeras_tpu_torch.serving.disagg` wire format), and admits
  the request there, where the admission hash-hits the adopted pinned
  run (zero re-prefill).  Residency digests gate the transfer: a
  decode replica already holding the stems skips the hop entirely.
  The shipped pin is released when the request goes terminal (the
  refcount story chaos leans on); ANY prefill-hop failure — death
  mid-transfer, allocator backpressure, geometry mismatch — falls
  back to plain routing, never a caller-visible error.
- **Token streaming.**  :meth:`Router.stream` relays the serving
  replica's live transcript (``partial()`` / ``GET /stream``)
  incrementally — first token long before the terminal result, the
  thing that makes a 2-stage request usable — and is reroute-safe
  because decode is deterministic: a rerouted request's regenerated
  transcript extends the already-streamed prefix bit-exactly.

Routing is host bookkeeping and HTTP: this module imports neither torch
nor an engine class (numpy and the stdlib only), and touches no device
memory.  Every thread it starts is named ``dkt-...``.

Thread safety: one ``serving.router`` :class:`TracedRLock` guards the
router's tables; replica engine locks nest INSIDE it (the router is
the outermost lock in the serving plane).  It is taken through
:func:`obs.held`, so the telemetry recorded under it is written once it
is released.
``enqueue``/``poll``/``take`` are safe from any thread; one thread
drives ``step()``/``pump()``.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.resilience.admission import (EngineClosed, QueueFull,
                                                 RequestResult)
from distkeras_tpu_torch.serving.disagg import (BlockShipment, decode_shipment,
                                          encode_shipment)
from distkeras_tpu_torch.serving.residency import stem_hexes
from distkeras_tpu_torch.utils.locks import TracedRLock

# Replica-local request-id bases: the router gives each attached
# in-process replica a disjoint id range (base, base + span) so one
# merged trace never holds two engines' colliding ids — what makes the
# cross-replica waterfall unambiguous.  Router-level ids stay below
# the first base.
RID_SPAN = 1_000_000


class ReplicaUnreachable(RuntimeError):
    """A remote replica stopped answering (connection refused/reset or
    timeout) — the router treats it as a death signal, not an error
    surfaced to callers."""


def _check_role(role):
    """Replica role labels: ``None`` = generalist (serves
    everything), ``"decode"`` = decode-specialized (a generalist to
    the routing rules, named for topology clarity), ``"prefill"`` =
    prefill-specialized (takes NO decode routes; serves the
    block-build half of disaggregated requests only)."""
    if role is not None and role not in ("prefill", "decode"):
        raise ValueError(
            f'role must be None, "prefill", or "decode", got {role!r}')
    return role


# ----------------------------------------------------------- replicas


class InProcessReplica:
    """A replica handle over an engine object in THIS process.

    ``engine`` is any serving engine exposing the admission surface
    (``enqueue``/``poll``/``step``/``residency``/``queued``/
    ``running``/``closed``) — the router never imports the engine
    classes.  ``health`` overrides the
    default liveness check (engine not closed) — e.g. a heartbeat-
    freshness callable for replicas whose process publishes beats.

    ``rid_base``: the replica-local request-id floor; assigned by
    :meth:`Router.add_replica` when None (disjoint ranges per replica,
    see module docstring).  ``start()`` optionally runs the decode
    loop on a daemon thread (the deployment shape where each replica
    steps itself — what the cross-host endpoint does in its own
    process); without it the router's ``step()`` drives the engine.
    """

    remote = False

    def __init__(self, name: str, engine, health=None,
                 rid_base: int | None = None, role: str | None = None):
        self.name = str(name)
        self.engine = engine
        self.role = _check_role(role)
        self._health = health
        self._failed = None
        if rid_base is not None:
            self.set_rid_base(rid_base)
        self._stop = threading.Event()
        self._thread = None

    def set_rid_base(self, base: int) -> None:
        if self.engine._next_id < base:
            self.engine._next_id = base

    # ----------------------------------------------- admission surface

    def enqueue(self, prompt, max_new_tokens: int, **kw) -> int:
        return self.engine.enqueue(prompt, max_new_tokens, **kw)

    def poll(self, request_id: int):
        return self.engine.poll(request_id)

    def partial(self, request_id: int):
        """Live transcript snapshot (the engines' ``partial()``) — the
        streaming relay's read."""
        return self.engine.partial(request_id)

    def step(self) -> None:
        self.engine.step()

    # ------------------------------------------------- block transfer

    def prefill_blocks(self, prompt) -> BlockShipment:
        """Build + export ``prompt``'s full-block KV run (paged
        engines only — the prefill half of a disaggregated hop)."""
        return self.engine.export_blocks(prompt)

    def import_blocks(self, shipment: BlockShipment):
        """Adopt a shipped run; the engine's
        ``{"prefix_id", ...}`` dict, or None under allocator
        backpressure."""
        return self.engine.import_blocks(shipment)

    def unpin(self, prefix_id: int) -> None:
        self.engine.unpin_prefix(prefix_id)

    # ------------------------------------------------- routing signals

    def healthy(self) -> bool:
        if self._failed is not None:
            return False
        if self._health is not None:
            return bool(self._health())
        return not self.engine.closed

    def residency(self) -> dict:
        return self.engine.residency()

    def load(self) -> tuple[int, int, int]:
        """``(queue_depth, lanes_busy, lanes)`` read live off the
        engine (cheap host counters)."""
        return (self.engine.queued, len(self.engine.running()),
                self.engine.lanes)

    def param_version(self) -> int:
        """The engine's live weight version (0 until the first
        ``swap_params``; engines without hot-swap report 0 forever)."""
        return int(getattr(self.engine, "param_version", 0))

    def swap_params(self, tree, version: int,
                    allow_downgrade: bool = False) -> int:
        """Live weight push passthrough — hot-swap engines
        only; the canary controller drives this."""
        return self.engine.swap_params(
            tree, version, allow_downgrade=allow_downgrade)

    # -------------------------------------------------- self-stepping

    def start(self, idle_s: float = 0.005) -> "InProcessReplica":
        """Run the decode loop on a daemon thread: step whenever work
        exists, nap ``idle_s`` when idle.  The per-replica step thread
        lets N in-process replicas decode concurrently (torch releases
        the GIL inside its kernels and while it waits on the device)."""
        if self._thread is not None:
            raise RuntimeError(f"replica {self.name} already started")
        self._stop.clear()
        self._failed = None

        def run():
            while not self._stop.is_set():
                try:
                    if self.engine.running() or self.engine.queued:
                        self.engine.step()
                    else:
                        self._stop.wait(idle_s)
                except Exception as e:  # noqa: BLE001 — a dead step
                    # thread must flip healthy() so the router
                    # reroutes, not hang its requests forever.
                    self._failed = e
                    return

        self._thread = threading.Thread(
            target=run, name=f"dkt-replica-{self.name}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class HttpReplica:
    """A replica handle over a cross-host :class:`EngineEndpoint`.

    ``addr`` is ``host:port`` (the endpoint publishes it into
    ``<coord_dir>/serve/host<N>.addr`` under the ``DKT_CLUSTER_*``
    substrate — see :func:`discover_replicas`).  Admission maps HTTP
    status to the engine contract: 429 -> :class:`QueueFull`, 503 ->
    :class:`EngineClosed`, connection failure ->
    :class:`ReplicaUnreachable` (a death signal the router turns into
    drain-and-reroute, never a caller-visible error).  Load/residency
    ride the ``/residency`` document and are cached between refreshes
    so routing decisions never block on the network.
    """

    remote = True

    def __init__(self, name: str, addr: str, timeout: float = 2.0,
                 role: str | None = None,
                 transfer_timeout: float = 30.0):
        self.name = str(name)
        self.addr = addr
        self.timeout = timeout
        self.role = _check_role(role)
        # Block transfers move O(prompt) cache bytes and the prefill
        # hop runs real compute — give them their own, longer budget
        # than the control-plane timeout.
        self.transfer_timeout = transfer_timeout
        self._cached: dict = {}

    def _url(self, path: str) -> str:
        return f"http://{self.addr}{path}"

    def _get(self, path: str) -> tuple[int, bytes]:
        try:
            with urllib.request.urlopen(self._url(path),
                                        timeout=self.timeout) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
        except Exception as e:  # noqa: BLE001 — refused/reset/timeout
            raise ReplicaUnreachable(
                f"replica {self.name} at {self.addr}: {e}") from e

    def enqueue(self, prompt, max_new_tokens: int, **kw) -> int:
        body = {"prompt": np.asarray(prompt, np.int32).tolist(),
                "max_new_tokens": int(max_new_tokens), **kw}
        req = urllib.request.Request(
            self._url("/enqueue"), data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout) as resp:
                return int(json.loads(resp.read())["request_id"])
        except urllib.error.HTTPError as e:
            detail = e.read().decode("utf-8", "replace")
            if e.code == 429:
                raise QueueFull(detail) from e
            if e.code == 503:
                raise EngineClosed(detail) from e
            raise ValueError(detail) from e
        except (QueueFull, EngineClosed):
            raise
        except Exception as e:  # noqa: BLE001 — refused/reset/timeout
            raise ReplicaUnreachable(
                f"replica {self.name} at {self.addr}: {e}") from e

    def poll(self, request_id: int):
        code, body = self._get(f"/poll?id={int(request_id)}")
        if code == 404:
            return None
        if code != 200:
            # A 5xx means the endpoint is up but erroring — treat it
            # like a death signal (drain-and-reroute is idempotent),
            # never let an error document parse as a result.
            raise ReplicaUnreachable(
                f"replica {self.name} at {self.addr}: poll returned "
                f"HTTP {code}: {body[:200]!r}")
        rec = json.loads(body)
        return RequestResult(
            request_id=int(rec["request_id"]),
            tokens=np.asarray(rec["tokens"], np.int32),
            status=rec["status"], prompt_len=int(rec["prompt_len"]),
            error=rec.get("error"))

    def partial(self, request_id: int):
        """Live transcript snapshot off ``GET /stream`` — terminal
        results included (same doc shape as ``/poll``), None for
        unknown ids."""
        code, body = self._get(f"/stream?id={int(request_id)}")
        if code == 404:
            return None
        if code != 200:
            raise ReplicaUnreachable(
                f"replica {self.name} at {self.addr}: stream returned "
                f"HTTP {code}: {body[:200]!r}")
        rec = json.loads(body)
        return RequestResult(
            request_id=int(rec["request_id"]),
            tokens=np.asarray(rec["tokens"], np.int32),
            status=rec["status"], prompt_len=int(rec["prompt_len"]),
            error=rec.get("error"))

    def step(self) -> None:
        """No-op: a remote replica's endpoint steps its own engine."""

    # ------------------------------------------------- block transfer

    def _post(self, path: str, data: bytes, content_type: str,
              timeout: float) -> bytes:
        req = urllib.request.Request(
            self._url(path), data=data,
            headers={"Content-Type": content_type}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            detail = e.read().decode("utf-8", "replace")
            if e.code == 429:
                raise QueueFull(detail) from e
            if e.code == 503:
                raise EngineClosed(detail) from e
            raise ValueError(detail) from e
        except (QueueFull, EngineClosed):
            raise
        except Exception as e:  # noqa: BLE001 — refused/reset/timeout
            raise ReplicaUnreachable(
                f"replica {self.name} at {self.addr}: {e}") from e

    def prefill_blocks(self, prompt) -> BlockShipment:
        """``POST /prefill``: build + export the prompt's full-block
        KV run on the remote replica; returns the decoded shipment.
        429 -> QueueFull (allocator backpressure), connection death ->
        ReplicaUnreachable — both fall back to plain routing."""
        body = {"prompt": np.asarray(prompt, np.int32).tolist()}
        data = self._post("/prefill", json.dumps(body).encode(),
                          "application/json", self.transfer_timeout)
        return decode_shipment(data)

    def import_blocks(self, shipment: BlockShipment):
        """``POST /blocks``: ship the run to the remote replica for
        adoption.  Mirrors the engine contract: the import dict on
        success, None under allocator backpressure (HTTP 429)."""
        try:
            body = self._post("/blocks", encode_shipment(shipment),
                              "application/octet-stream",
                              self.transfer_timeout)
        except QueueFull:
            return None
        return json.loads(body)

    def unpin(self, prefix_id: int) -> None:
        self._post("/unpin",
                   json.dumps({"prefix_id": int(prefix_id)}).encode(),
                   "application/json", self.timeout)

    def healthy(self) -> bool:
        try:
            code, _ = self._get("/healthz")
        except ReplicaUnreachable:
            return False
        return code == 200

    def residency(self) -> dict:
        _, body = self._get("/residency")
        self._cached = json.loads(body)
        return self._cached

    def load(self) -> tuple[int, int, int]:
        c = self._cached
        return (int(c.get("queue_depth", 0)),
                int(c.get("lanes_busy", 0)), int(c.get("lanes", 1)))

    def param_version(self) -> int:
        """Weight version from the last ``/residency`` poll (0 until
        one lands — same staleness contract as :meth:`load`)."""
        return int(self._cached.get("param_version", 0))


def discover_replicas(coord_dir: str, timeout: float = 2.0
                      ) -> list[HttpReplica]:
    """Build :class:`HttpReplica` handles from the ``serve/`` address
    ledger an :class:`EngineEndpoint` publishes under the cluster
    coordination directory (the same atomic-file pattern as the
    telemetry federation's ``telemetry/`` ledger)."""
    import os

    d = os.path.join(coord_dir, "serve")
    out = []
    if not os.path.isdir(d):
        return out
    for name in sorted(os.listdir(d)):
        if not (name.startswith("host") and name.endswith(".addr")):
            continue
        try:
            with open(os.path.join(d, name), encoding="utf-8") as f:
                rec = json.load(f)
            out.append(HttpReplica(f"host{int(rec['host'])}",
                                   rec["addr"], timeout=timeout,
                                   role=rec.get("role")))
        except (OSError, ValueError, KeyError):
            continue  # torn publish mid-replace: skip this pass
    return out


# ------------------------------------------------------------- router


@dataclasses.dataclass
class _Member:
    replica: object
    up: bool = True
    draining: bool = False
    degraded_until: float = 0.0
    last_health: float = 0.0
    inflight: int = 0


@dataclasses.dataclass
class _Routed:
    request_id: int
    prompt: np.ndarray
    max_new: int
    kw: dict
    deadline: float | None
    born: float
    prefix_id: object
    replica: str | None = None
    replica_rid: int | None = None
    epoch: int = 0
    hops: int = 0
    # Disagg import pin held on the decode side: (replica_name,
    # prefix_id), released (queued to the pump's unpin drain) when the
    # request goes terminal or its holder dies — the refcount story.
    pin: tuple | None = None
    # Warm-prompt stem digests per block size, computed lazily (one
    # request may be scored against replicas with different blocks).
    stems: dict = dataclasses.field(default_factory=dict)

    def stems_at(self, block: int) -> list[str]:
        if block not in self.stems:
            self.stems[block] = stem_hexes(self.prompt[:-1], block)
        return self.stems[block]


class Router:
    """Cache-aware request router over N engine replicas (module
    docstring has the full story).

    ``replicas``: initial handles (:class:`InProcessReplica` /
    :class:`HttpReplica` / any object with the same surface); more
    join via :meth:`add_replica`.  ``policy``: ``"affinity"`` (stem/
    prefix residency first, least-loaded fallback — the default),
    ``"least_loaded"`` (residency ignored), or ``"round_robin"`` (the
    bench baseline).  ``health_interval`` / ``residency_interval``:
    probe cadences (seconds on ``clock``, injectable for tests).

    The admission surface mirrors the engines': :meth:`enqueue`
    returns a fleet-wide request id immediately (``QueueFull`` only
    when EVERY live replica is saturated; ``EngineClosed`` after
    :meth:`begin_shutdown` — and EngineClosed wins the race, same
    contract as the engines); results arrive via :meth:`poll` /
    :meth:`take` / :meth:`results`; :meth:`drain` blocks for one
    request; :meth:`shutdown` drains everything.  :meth:`step` drives
    in-process replicas one decode step and pumps; self-stepping
    replicas (``InProcessReplica.start()`` / remote endpoints) only
    need :meth:`pump`.
    """

    def __init__(self, replicas=(), *, policy: str = "affinity",
                 clock=None, health_interval: float = 0.5,
                 residency_interval: float = 2.0,
                 degrade_cooldown: float = 5.0,
                 poll_s: float = 0.005):
        if policy not in ("affinity", "least_loaded", "round_robin"):
            raise ValueError(
                f"policy must be affinity|least_loaded|round_robin, "
                f"got {policy!r}")
        self.policy = policy
        self._clock = clock if clock is not None else time.monotonic
        self.health_interval = health_interval
        self.residency_interval = residency_interval
        self.degrade_cooldown = degrade_cooldown
        self.poll_s = poll_s
        # Outermost serving-plane lock: replica engine admission locks
        # nest INSIDE it.
        self._lock = TracedRLock("serving.router")
        self._members: dict[str, _Member] = {}
        self._affinity: dict[str, dict] = {}
        self._requests: dict[int, _Routed] = {}
        self._completed: dict[int, RequestResult] = {}
        self._pending: list[int] = []   # accepted but currently unrouted
        # Import pins awaiting release (network I/O — drained OUTSIDE
        # the router lock at the end of each pump round).
        self._unpins: list[tuple] = []
        self._next_id = 0
        # Router-assigned in-process bases start HIGH so they can
        # never collide with EngineEndpoint's host-id-derived bases
        # ((host_id + 1) * RID_SPAN) in a mixed fleet — the waterfall
        # leans on fleet-wide id disjointness.
        self._next_base = 1000 * RID_SPAN
        self._rr = 0
        self._closed = False
        self.epoch = 0
        self._last_residency = -float("inf")
        for r in replicas:
            self.add_replica(r)

    # ------------------------------------------------------ membership

    def add_replica(self, replica) -> None:
        """Join a replica.  In-process replicas get a disjoint
        request-id range; the affinity table seeds from the replica's
        residency digest (best effort — a dead-on-arrival replica
        joins DOWN and is retried by health probing)."""
        with obs.held(self._lock):
            name = replica.name
            if name in self._members:
                raise ValueError(f"replica {name!r} already attached")
            if not getattr(replica, "remote", False):
                replica.set_rid_base(self._next_base)
            self._next_base += RID_SPAN
            self._members[name] = _Member(replica,
                                          last_health=self._clock())
            self.epoch += 1
        ok = self._refresh_one(name)
        with obs.held(self._lock):
            if name in self._members:
                self._members[name].up = ok
        obs.event("router.replica_join", replica=name, up=ok,
                  epoch=self.epoch)

    def remove_replica(self, name: str):
        """Leave: reroute the replica's unfinished requests, then drop
        it from membership.  Returns the detached replica handle —
        the autoscaler pools a retired (still-warm) handle for later
        re-admission; other callers may ignore it."""
        with obs.held(self._lock):
            if name not in self._members:
                raise KeyError(f"unknown replica {name!r}")
            self._members[name].draining = True
            self.epoch += 1
            self._reroute_from_locked(name, why="removed")
            handle = self._members.pop(name).replica
            self._affinity.pop(name, None)
        obs.event("router.replica_leave", replica=name,
                  epoch=self.epoch)
        return handle

    def drain_replica(self, name: str) -> None:
        """Graceful drain: stop routing to the replica and re-admit
        its unfinished accepted requests elsewhere.  The replica
        object itself is untouched (its owner decides shutdown)."""
        with obs.held(self._lock):
            m = self._members.get(name)
            if m is None:
                raise KeyError(f"unknown replica {name!r}")
            m.draining = True
            self.epoch += 1
            self._reroute_from_locked(name, why="draining")
        obs.event("router.replica_drain", replica=name,
                  epoch=self.epoch)

    def replicas_up(self) -> list[str]:
        with obs.held(self._lock):
            return sorted(n for n, m in self._members.items()
                          if m.up and not m.draining)

    def mark_degraded(self, name: str,
                      cooldown: float | None = None) -> None:
        """Demote a replica in the least-loaded ordering for
        ``cooldown`` seconds — the `slo.breach` hook (see
        :meth:`breach_demoter`)."""
        with obs.held(self._lock):
            m = self._members.get(name)
            if m is None:
                return
            m.degraded_until = self._clock() + (
                self.degrade_cooldown if cooldown is None else cooldown)
        obs.event("router.replica_degraded", replica=name)

    def slo_rules(self, *templates) -> list:
        """Stamp ``SloRule`` templates per attached replica (round
        14): one ``replica=``-labeled copy of each template for every
        replica currently attached, in name order.  Pass the result to
        ``obs.session(slo_rules=...)`` and subscribe
        :meth:`breach_demoter` ONCE — a breach then demotes the
        replica its rule is scoped to, no hand-built closure per
        replica.  (Rules are snapshots: re-derive after membership
        changes if new replicas need coverage.)"""
        import dataclasses as _dc

        with obs.held(self._lock):
            names = sorted(self._members)
        return [_dc.replace(t, replica=n)
                for n in names for t in templates]

    def breach_demoter(self, name: str | None = None):
        """A subscriber for ``obs.SloRule`` breach callbacks
        (``fn(rule, value)``).

        With ``name``: any breach demotes that fixed replica — the
        shape for cross-host fleets where each replica process runs
        its own rules and the operator maps streams to names.  With
        no argument: the subscriber reads the RULE's own
        ``replica=`` label (see :meth:`slo_rules`) and demotes that
        replica — attach it once for the whole fleet; breaches from
        unlabeled rules are ignored."""
        def on_breach(rule, value):
            del value
            target = name if name is not None \
                else getattr(rule, "replica", None)
            if target is not None:
                self.mark_degraded(target)
        return on_breach

    # ------------------------------------------------------- admission

    def enqueue(self, prompt, max_new_tokens: int, ttl=None,
                deadline=None, **submit_kw) -> int:
        """Route and admit one request; returns the fleet-wide request
        id.  ``QueueFull`` spills to the next candidate replica and
        reaches the caller only when every live replica is saturated;
        an expired-on-arrival deadline records a structured timeout
        (engine contract).  ``submit_kw`` forwards to the replica's
        ``enqueue`` (per-request keys / sampling overrides /
        ``prefix_id``)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if ttl is not None and deadline is not None:
            raise ValueError("pass ttl (relative) OR deadline "
                             "(absolute), not both")
        with obs.held(self._lock):
            if self._closed:
                raise EngineClosed(
                    "router is shutting down (begin_shutdown was "
                    "called); no new requests are admitted during "
                    "drain")
            now = self._clock()
            dl = now + ttl if ttl is not None else deadline
            rid = self._next_id
            self._next_id += 1
            obs.event("router.submit", request_id=rid,
                      prompt_len=int(prompt.size),
                      max_new=int(max_new_tokens))
            req = _Routed(request_id=rid, prompt=prompt,
                          max_new=int(max_new_tokens), kw=submit_kw,
                          deadline=dl, born=now,
                          prefix_id=submit_kw.get("prefix_id"))
            if dl is not None and dl <= now:
                self._finish_locked(req, prompt, "timeout",
                                    prompt.size)
                return rid
            self._requests[rid] = req
            plan = self._disagg_plan_locked(req)
        try:
            # The 2-stage hop (prefill + block transfer) is network/
            # compute I/O and runs OUTSIDE the router lock; any
            # failure inside it falls back to plain routing.
            routed = (plan is not None
                      and self._disagg_enqueue(req, plan))
            if not routed:
                with obs.held(self._lock):
                    self._route_locked(req)
        except BaseException:
            # Not accepted (QueueFull everywhere / no live
            # replica / validation): the id must not linger as an
            # accepted request for shutdown to "cancel" — and an
            # import pin taken for it must be handed back.
            with obs.held(self._lock):
                dropped = self._requests.pop(rid, None)
                if dropped is not None and dropped.pin is not None:
                    self._unpins.append(dropped.pin)
                    dropped.pin = None
            self._drain_unpins()
            raise
        return rid

    # submit() is enqueue() here on purpose: a fleet has no stable
    # lane ids to hand back, so the id-keyed surface IS the surface
    # (the same argument as the elastic engine's enqueue-only rule).
    submit = enqueue

    def poll(self, request_id: int):
        """The request's :class:`RequestResult` (re-keyed to the
        fleet-wide id), or None while it decodes."""
        with obs.held(self._lock):
            return self._completed.get(request_id)

    def take(self, request_id: int):
        with obs.held(self._lock):
            return self._completed.pop(request_id)

    def results(self) -> dict:
        with obs.held(self._lock):
            out = self._completed
            self._completed = {}
            return out

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def queued(self) -> int:
        """Accepted requests currently awaiting a replica slot (the
        router-level backlog; replica-level queues are on top)."""
        with obs.held(self._lock):
            return len(self._pending)

    # ----------------------------------------------------- fleet state

    def fleet_snapshot(self) -> dict:
        """One CONSISTENT read of the whole fleet under a single lock
        acquisition: ``{"epoch", "pending", "closed", "replicas":
        {name: {...}}}`` with per-replica up/draining/degraded flags,
        live load (``queue_depth``/``lanes_busy``/``lanes`` plus the
        router's ``inflight`` debit and the combined ``load`` scoring
        key), role, and the affinity view (``prefix_ids`` /
        ``stems`` / ``block``).

        This is THE fleet-state read: the route scorer, the disagg
        planner, and the autoscaler all consume it, so a
        membership flip can never be observed torn against the load
        fields it changes — the ad-hoc per-field reads those
        consumers used to make individually are gone."""
        with obs.held(self._lock):
            return self._fleet_snapshot_locked()

    def replica_handles(self) -> dict:
        """``{name: replica}`` — the live member handles under one
        lock acquisition.  The canary controller's swap surface
       : it needs the handles themselves (to call
        ``swap_params``), which the dict-of-dicts snapshot above
        deliberately does not carry."""
        with obs.held(self._lock):
            return {n: m.replica for n, m in self._members.items()}

    def bump_epoch(self, reason: str) -> int:
        """Advance the route epoch without a membership change — the
        canary controller's promote/rollback commit point:
        a weight push changes what the fleet SERVES, so in-flight
        routing state made under the old version set is re-stamped
        the same way a drain re-stamps it.  Event emitted after the
        lock is released (the drain-path convention)."""
        with obs.held(self._lock):
            self.epoch += 1
            epoch = self.epoch
        obs.event("router.epoch_bump", reason=str(reason), epoch=epoch)
        return epoch

    def _fleet_snapshot_locked(self) -> dict:
        now = self._clock()
        reps = {}
        for n, m in self._members.items():
            q, busy, lanes = m.replica.load()
            load = (busy + q) / max(lanes, 1) + m.inflight
            obs.gauge("router.replica_load", load, replica=n)
            tab = self._affinity.get(n, {})
            reps[n] = {
                "up": m.up, "draining": m.draining,
                "degraded": m.degraded_until > now,
                "inflight": m.inflight,
                "role": getattr(m.replica, "role", None),
                "queue_depth": q, "lanes_busy": busy, "lanes": lanes,
                "load": load,
                "prefix_ids": frozenset(tab.get("prefix_ids", ())),
                "stems": len(tab.get("stem_hashes", ())),
                "block": tab.get("block"),
                # The live weight version (0 = never swapped).  The
                # canary controller and the request waterfalls read it;
                # the autoscaler ignores it (its policies key on the
                # named load fields above).
                "param_version": (m.replica.param_version()
                                  if hasattr(m.replica,
                                             "param_version") else 0),
            }
        return {"epoch": self.epoch, "pending": len(self._pending),
                "closed": self._closed, "replicas": reps}

    # --------------------------------------------------------- routing

    def _candidates_locked(self, req: _Routed, exclude):
        now = self._clock()
        # Prefill-specialized replicas take no decode routes: they
        # serve the block-build half of disaggregated requests only.
        cands = [m for n, m in self._members.items()
                 if m.up and not m.draining and n not in exclude
                 and getattr(m.replica, "role", None) != "prefill"]
        if req.prefix_id is not None:
            have = [m for m in cands
                    if req.prefix_id in self._affinity.get(
                        m.replica.name, {}).get("prefix_ids", ())]
            if not have:
                raise ValueError(
                    f"prefix_id {req.prefix_id} is not resident on "
                    "any live replica (pool entries are replica-"
                    "local; pin it somewhere first)")
            cands = have
        return cands, now

    def _affinity_score(self, req: _Routed, name: str) -> int:
        tab = self._affinity.get(name)
        if not tab:
            return 0
        score = 0
        block = tab.get("block")
        if block:
            resident = tab.get("stem_hashes", ())
            for h in req.stems_at(block):
                if h in resident:
                    score += block
                else:
                    break
        if req.prefix_id is not None and \
                req.prefix_id in tab.get("prefix_ids", ()):
            score += 1
        return score

    def _route_locked(self, req: _Routed, exclude=frozenset(),
                      rerouting: bool = False,
                      prefer: str | None = None) -> bool:
        """Pick a replica and admit ``req`` on it.  Returns True on
        acceptance; parks the request in the router backlog (False)
        when every candidate is saturated AND the request was already
        accepted (a reroute must never surface QueueFull to a caller
        who holds an id); raises QueueFull for a fresh enqueue.
        ``prefer`` front-runs one replica in the candidate order (the
        disagg hop's decode target, which now holds the shipped
        blocks) without bypassing spillover."""
        if req.request_id in self._completed:
            return True  # finished while its enqueue ran unlocked
        try:
            cands, now = self._candidates_locked(req, exclude)
        except ValueError:
            if not rerouting:
                raise
            # Pool entries are replica-local: a prefix_id request
            # whose only advertising replica died cannot be served
            # anywhere — terminal structured error, never an
            # exception out of the pump round.
            self._finish_locked(
                req, req.prompt, "error", req.prompt.size,
                error=f"prefix_id {req.prefix_id} is no longer "
                      "resident on any live replica (its replica "
                      "died or drained)")
            return True
        if not cands and not rerouting:
            raise RuntimeError("router has no live replicas")
        del now
        # ONE consistent fleet read scores every candidate: the
        # degraded flag and the load key come from the same snapshot
        # (the scorer can never see them torn).
        fleet = self._fleet_snapshot_locked()["replicas"]
        scored = []
        for m in cands:
            s = (self._affinity_score(req, m.replica.name)
                 if self.policy == "affinity" else 0)
            degraded = 1 if fleet[m.replica.name]["degraded"] else 0
            scored.append((m, s, degraded))
        if self.policy == "round_robin":
            order = sorted(scored, key=lambda t: t[2])
            order = order[self._rr % len(order):] \
                + order[:self._rr % len(order)] if order else order
            self._rr += 1
        else:
            order = sorted(
                scored,
                key=lambda t: (-t[1], t[2],
                               fleet[t[0].replica.name]["load"],
                               t[0].replica.name))
        if prefer is not None:
            # Stable re-sort: the preferred replica front-runs, the
            # rest keep their relative order (spillover path intact).
            order.sort(key=lambda t: t[0].replica.name != prefer)
        saw_full = False
        for i, (m, score, _deg) in enumerate(order):
            name = m.replica.name
            kw = dict(req.kw)
            if req.deadline is not None:
                remaining = req.deadline - self._clock()
                if remaining <= 0:
                    self._finish_locked(req, req.prompt, "timeout",
                                        req.prompt.size)
                    return True
                kw["ttl"] = remaining
            try:
                rrid = m.replica.enqueue(req.prompt, req.max_new, **kw)
            except QueueFull:
                saw_full = True
                continue
            except (EngineClosed, ReplicaUnreachable):
                # Racing its own shutdown/death: health probing will
                # flip it down; skip it for this route.
                continue
            reason = ("reroute" if rerouting
                      else "spillover" if i > 0
                      else "affinity" if score > 0
                      else self.policy if self.policy != "affinity"
                      else "least_loaded")
            req.replica, req.replica_rid = name, rrid
            req.epoch = self.epoch
            m.inflight += 1
            obs.count("router.requests", replica=name, reason=reason)
            if reason == "affinity":
                obs.count("router.affinity_hits")
            obs.event("router.route", request_id=req.request_id,
                      replica=name, replica_request_id=rrid,
                      reason=reason, hop=req.hops)
            # Optimistic history insert: the stems this request
            # prefills become resident on that replica.
            tab = self._affinity.setdefault(
                name, {"stem_hashes": set(), "prefix_ids": set(),
                       "block": None})
            if tab.get("block"):
                tab["stem_hashes"].update(
                    req.stems_at(tab["block"]))
            return True
        if rerouting:
            # Accepted request, fleet momentarily saturated: park in
            # the router backlog; pump() retries.
            req.replica, req.replica_rid = None, None
            if req.request_id not in self._pending:
                self._pending.append(req.request_id)
            obs.gauge("router.pending", len(self._pending))
            return False
        if saw_full:
            raise QueueFull(
                f"all {len(cands)} live replica(s) are saturated "
                "(every admission queue full); shed load or add "
                "replicas")
        raise RuntimeError(
            "no live replica accepted the request (all closed or "
            "unreachable)")

    def _reroute_from_locked(self, name: str, why: str) -> None:
        for req in list(self._requests.values()):
            if req.replica != name or req.request_id \
                    in self._completed:
                continue
            req.hops += 1
            if req.pin is not None:
                # The new replica re-prefills from scratch; the old
                # pin buys nothing there — queue its release (a dead
                # holder's pin is simply dropped by the drain).
                self._unpins.append(req.pin)
                req.pin = None
            obs.count("router.reroutes")
            obs.event("router.reroute", request_id=req.request_id,
                      src=name, why=why, hop=req.hops)
            self._route_locked(req, exclude={name}, rerouting=True)
        m = self._members.get(name)
        if m is not None:
            m.inflight = 0

    # ------------------------------------------- disaggregated 2-stage

    def _disagg_plan_locked(self, req: _Routed) -> str | None:
        """Decide whether ``req`` takes the 2-stage prefill/decode hop;
        returns the chosen prefill replica's name, or None for plain
        routing.  Plain routing wins when: no up prefill replica; the
        request rides a prefix-pool pin (warm by construction); the
        warm prompt spans less than one full block (nothing to ship);
        or some decode candidate's affinity table already covers every
        stem — the residency gate: shipping blocks the fleet already
        holds is pure waste, route to the warm replica instead."""
        if req.prefix_id is not None:
            return None
        pre = [(n, m) for n, m in self._members.items()
               if m.up and not m.draining
               and getattr(m.replica, "role", None) == "prefill"]
        if not pre:
            return None
        # Prefill + decode replicas run the same slab geometry; read
        # the block size off any affinity entry that advertises one.
        block = None
        for tab in self._affinity.values():
            if tab.get("block"):
                block = tab["block"]
                break
        if block is None:
            return None
        stems = req.stems_at(block)
        if not stems:
            return None  # warm prompt under one block
        for n, m in self._members.items():
            if not m.up or m.draining \
                    or getattr(m.replica, "role", None) == "prefill":
                continue
            resident = self._affinity.get(n, {}).get("stem_hashes", ())
            if all(h in resident for h in stems):
                obs.count("router.disagg_warm_skips")
                return None
        fleet = self._fleet_snapshot_locked()["replicas"]
        name, _m = min(pre, key=lambda t: (fleet[t[0]]["load"], t[0]))
        return name

    def _disagg_enqueue(self, req: _Routed, prefill_name: str) -> bool:
        """The 2-stage hop: build ``req``'s KV blocks on the prefill
        replica, ship them to the best decode candidate, and admit the
        request there — where admission hash-hits the adopted pinned
        run (zero re-prefill).  Runs OUTSIDE the router lock (the hop
        is prefill compute plus block-transfer network I/O).  Returns
        True once the request is admitted; returns False on ANY hop
        failure — prefill death mid-transfer, allocator backpressure,
        geometry mismatch — so ``enqueue`` falls back to plain
        routing, never a caller-visible error."""
        rid = req.request_id
        with obs.held(self._lock):
            m = self._members.get(prefill_name)
            if m is None or not m.up or m.draining:
                return False
            prefill = m.replica
        try:
            with obs.span("router.prefill", request_id=rid,
                          replica=prefill_name):
                ship = prefill.prefill_blocks(req.prompt)
        except Exception as e:  # noqa: BLE001 — any failure: fall back
            obs.count("router.disagg_fallbacks", stage="prefill")
            obs.event("router.disagg_fallback", request_id=rid,
                      stage="prefill", replica=prefill_name,
                      error=f"{type(e).__name__}: {e}")
            return False
        # Pick the decode target exactly the way _route_locked would
        # (affinity first, degraded demoted, least-loaded tiebreak) so
        # the blocks ship to where admission will land.
        with obs.held(self._lock):
            try:
                cands, now = self._candidates_locked(req, frozenset())
            except ValueError:
                return False
            if not cands:
                return False
            del now
            fleet = self._fleet_snapshot_locked()["replicas"]
            scored = [(m2,
                       self._affinity_score(req, m2.replica.name)
                       if self.policy == "affinity" else 0,
                       1 if fleet[m2.replica.name]["degraded"] else 0)
                      for m2 in cands]
            order = sorted(scored,
                           key=lambda t: (-t[1], t[2],
                                          fleet[t[0].replica.name]
                                          ["load"],
                                          t[0].replica.name))
            target = order[0][0].replica
            tname = target.name
            resident = set(self._affinity.get(tname, {})
                           .get("stem_hashes", ()))
        hexes = ship.hexes()
        imported = None
        if not all(h in resident for h in hexes):
            try:
                with obs.span("router.transfer", request_id=rid,
                              src=prefill_name, dst=tname):
                    imported = target.import_blocks(ship)
            except Exception as e:  # noqa: BLE001 — fall back
                obs.count("router.disagg_fallbacks", stage="transfer")
                obs.event("router.disagg_fallback", request_id=rid,
                          stage="transfer", replica=tname,
                          error=f"{type(e).__name__}: {e}")
                return False
            if imported is None:  # allocator backpressure on target
                obs.count("router.disagg_fallbacks", stage="adopt")
                obs.event("router.disagg_fallback", request_id=rid,
                          stage="adopt", replica=tname,
                          error="no free block on decode target")
                return False
            obs.count("router.transfer_bytes", float(ship.nbytes))
            obs.event("router.block_transfer", request_id=rid,
                      src=prefill_name, dst=tname,
                      bytes=int(ship.nbytes), blocks=len(ship),
                      hits=int(imported.get("hits", 0)))
        else:
            # The target grew the stems while the prefill ran (another
            # request's optimistic insert): skip the transfer.
            obs.count("router.disagg_warm_skips")
        with obs.held(self._lock):
            if rid not in self._requests:
                # Finished/cancelled while the hop ran (shutdown or
                # deadline race): nothing left to route, but an
                # imported pin must still be handed back.
                if imported is not None:
                    self._unpins.append(
                        (tname, int(imported["prefix_id"])))
                return True
            if imported is not None:
                req.pin = (tname, int(imported["prefix_id"]))
                # Ground truth, not optimism: the shipment IS resident
                # on the target now — score it so admission routes
                # there as an affinity hit.
                tab = self._affinity.setdefault(
                    tname, {"stem_hashes": set(), "prefix_ids": set(),
                            "block": None})
                if not tab.get("block"):
                    tab["block"] = ship.block
                tab["stem_hashes"].update(hexes)
            self._route_locked(req, prefer=tname)
            if req.pin is not None and req.replica != tname:
                # Spilled past the warm target (its queue filled
                # during the hop): the pin buys nothing — hand it
                # back rather than hold blocks hostage.
                self._unpins.append(req.pin)
                req.pin = None
        obs.count("router.disagg_requests")
        self._drain_unpins()
        return True

    def _drain_unpins(self) -> None:
        """Release queued import pins (best effort — network I/O, runs
        OUTSIDE the router lock at the end of each pump round).  A pin
        whose holder died or left membership is dropped: its blocks
        died with that cache, there is nothing to release."""
        with obs.held(self._lock):
            if not self._unpins:
                return
            pins, self._unpins = self._unpins, []
            handles = {n: m.replica for n, m in self._members.items()}
        for name, pid in pins:
            r = handles.get(name)
            if r is None:
                continue
            try:
                r.unpin(pid)
            except Exception:  # noqa: BLE001 — dead/racing replica:
                pass           # the pin died with its cache

    # ---------------------------------------------------- result pump

    def _finish_locked(self, req: _Routed, tokens, status: str,
                       prompt_len: int, error=None) -> None:
        self._completed[req.request_id] = RequestResult(
            request_id=req.request_id,
            tokens=np.asarray(tokens, np.int32), status=status,
            prompt_len=prompt_len, error=error)
        self._requests.pop(req.request_id, None)
        if req.pin is not None:
            # Terminal: hand the shipped blocks back (refcount story —
            # the drain runs outside the lock at the next pump round).
            self._unpins.append(req.pin)
            req.pin = None
        obs.count("router.finished", status=status)
        obs.event("router.finish", request_id=req.request_id,
                  status=status, replica=req.replica,
                  hops=req.hops)
        if obs.active() is not None:
            obs.observe("router.request_s", self._clock() - req.born,
                        status=status)

    def _refresh_one(self, name: str) -> bool:
        """Pull one replica's residency digest into the affinity
        table (network I/O for remote replicas — runs OUTSIDE the
        router lock).  Returns reachability."""
        with obs.held(self._lock):
            m = self._members.get(name)
            if m is None:
                return False
            replica = m.replica
        try:
            res = replica.residency()
        except Exception:  # noqa: BLE001 — unreachable OR a malformed
            return False   # doc: either way, not a usable table yet
        tab = {"stem_hashes": set(res.get("stem_hashes", ())),
               "prefix_ids": set(res.get("prefix_ids", ())),
               "block": res.get("block")}
        with obs.held(self._lock):
            if name in self._members:
                self._affinity[name] = tab
        return True

    def refresh_residency(self) -> None:
        """Rebuild the affinity table from every up replica's
        residency digest (ground truth replaces the optimistic
        history)."""
        with obs.held(self._lock):
            names = [n for n, m in self._members.items() if m.up]
            self._last_residency = self._clock()
        for n in names:
            self._refresh_one(n)

    def pump(self) -> list[int]:
        """One router bookkeeping round: poll every routed request's
        CURRENT replica, collect results, health-gate membership
        (down replicas trigger drain-and-reroute, recovered ones
        rejoin under a new epoch), retry the parked backlog, and
        refresh residency on cadence.  Returns newly completed
        request ids.  Poll and health network I/O run OUTSIDE the
        router lock; re-admission to a replica (the reroute/backlog
        ``enqueue``) runs under it — route-and-record must be atomic
        — so with remote replicas that leg can hold the lock for up
        to the replica timeout per candidate (the bounded stall the
        lock inventory documents)."""
        with obs.held(self._lock):
            now = self._clock()
            todo = [(req.request_id, req.replica, req.replica_rid,
                     req.epoch)
                    for req in self._requests.values()
                    if req.replica is not None]
            due = [(n, m.replica) for n, m in self._members.items()
                   if now - m.last_health >= self.health_interval]
            replicas = {n: m.replica for n, m in self._members.items()}
            residency_due = (now - self._last_residency
                             >= self.residency_interval)

        polled: dict[int, object] = {}
        assignment = {rid: (name, rrid, ep)
                      for rid, name, rrid, ep in todo}
        dead: set[str] = set()
        for rid, name, rrid, _ep in todo:
            if name in dead:
                continue
            try:
                polled[rid] = replicas[name].poll(rrid)
            except ReplicaUnreachable:
                dead.add(name)
        health: dict[str, bool] = {}
        for n, replica in due:
            if n in dead:
                health[n] = False
                continue
            try:
                health[n] = replica.healthy()
            except Exception:  # noqa: BLE001 — a broken probe is down
                health[n] = False

        completed = []
        with obs.held(self._lock):
            now = self._clock()
            # Results FIRST, membership second: a request its replica
            # finished just before dying must be recorded, not
            # rerouted (and the inflight accounting must hit the
            # replica that actually served it).
            for rid, res in polled.items():
                req = self._requests.get(rid)
                if req is None or res is None:
                    continue
                name, rrid, _ep = assignment[rid]
                if (req.replica != name or req.replica_rid != rrid
                        or rid in self._completed):
                    # Rerouted/finished while the poll was in flight:
                    # the result belongs to a STALE hop — drop it
                    # (the epoch-stamped-assignment check; recording
                    # it would also debit the new replica's inflight
                    # for work it is still doing).
                    continue
                m = self._members.get(name)
                if m is not None and m.inflight > 0:
                    m.inflight -= 1
                self._finish_locked(req, res.tokens, res.status,
                                    res.prompt_len, error=res.error)
                completed.append(rid)
            for n, ok in health.items():
                m = self._members.get(n)
                if m is None:
                    continue
                m.last_health = now
                if m.up and not ok:
                    m.up = False
                    self.epoch += 1
                    obs.event("router.replica_down", replica=n,
                              epoch=self.epoch)
                    self._reroute_from_locked(n, why="health")
                elif not m.up and ok:
                    m.up = True
                    self.epoch += 1
                    # Its cache died with it: a fresh affinity entry,
                    # refilled from residency on the next refresh.
                    self._affinity.pop(n, None)
                    obs.event("router.replica_up", replica=n,
                              epoch=self.epoch)
            for n in dead:
                m = self._members.get(n)
                if m is not None and m.up:
                    m.up = False
                    self.epoch += 1
                    obs.event("router.replica_down", replica=n,
                              epoch=self.epoch)
                    self._reroute_from_locked(n, why="unreachable")
            # Parked backlog: a replica may have freed capacity.
            still = []
            for rid in self._pending:
                req = self._requests.get(rid)
                if req is None:
                    continue
                if not self._route_locked(req, rerouting=True):
                    still.append(rid)
            self._pending = still
            obs.gauge("router.pending", len(self._pending))
        # Release import pins freed by the finishes/reroutes above —
        # outside the lock (remote unpins are network I/O).
        self._drain_unpins()
        if residency_due:
            self.refresh_residency()
        return completed

    def step(self) -> list[int]:
        """Drive one decode step on every up in-process replica, then
        :meth:`pump`.  Replica engine locks are taken OUTSIDE the
        router lock here (step is long; holding the router lock
        across it would stall concurrent enqueues)."""
        with obs.held(self._lock):
            reps = [m.replica for m in self._members.values()
                    if m.up and not getattr(m.replica, "remote", False)]
        for r in reps:
            try:
                r.step()
            except Exception:  # noqa: BLE001 — a dying replica's step
                pass           # failure is health probing's to report
        return self.pump()

    # -------------------------------------------------------- lifecycle

    def drain(self, request_id: int, max_steps: int = 100_000):
        """Block until ``request_id`` finishes (driving
        :meth:`step`); returns its result."""
        for _ in range(max_steps):
            with obs.held(self._lock):
                res = self._completed.get(request_id)
                known = request_id in self._requests
            if res is not None:
                return res
            if not known:
                raise KeyError(f"unknown request {request_id}")
            self.step()
            if self._all_remote():
                time.sleep(self.poll_s)
        raise TimeoutError(
            f"request {request_id} did not finish in {max_steps} "
            "steps")

    def stream(self, request_id: int, max_steps: int = 100_000):
        """Incremental token relay for one request: a generator that
        yields each newly generated token (ints; prompt excluded) as
        the serving replica emits it, ending when the request goes
        terminal — the caller holds the first token long before the
        terminal result, which is what makes a 2-stage disaggregated
        request USABLE.  Reads the replica's live transcript
        (``partial()`` in-process, ``GET /stream`` remote) and drives
        :meth:`step` between reads (same loop shape as :meth:`drain`).
        Reroute-safe because decode is deterministic: a rerouted
        request's regenerated transcript extends the already-streamed
        prefix bit-exactly, so the cursor never rewinds and nothing is
        double-yielded.  Raises ``KeyError`` for unknown ids and
        ``TimeoutError`` past ``max_steps``."""
        emitted = 0
        for _ in range(max_steps):
            with obs.held(self._lock):
                res = self._completed.get(request_id)
                req = self._requests.get(request_id)
                replica = rrid = None
                if res is None and req is not None \
                        and req.replica is not None:
                    m = self._members.get(req.replica)
                    if m is not None:
                        replica, rrid = m.replica, req.replica_rid
            if res is None and req is None:
                raise KeyError(f"unknown request {request_id}")
            snap = res
            if snap is None and replica is not None \
                    and rrid is not None:
                part = getattr(replica, "partial", None)
                if part is not None:
                    try:
                        snap = part(rrid)
                    except ReplicaUnreachable:
                        snap = None  # pump's reroute will re-home it
            if snap is not None:
                toks = np.asarray(snap.tokens)
                cut = int(snap.prompt_len) + emitted
                if toks.size > cut:
                    for t in toks[cut:]:
                        emitted += 1
                        yield int(t)
                    obs.event("router.stream", request_id=request_id,
                              tokens=emitted)
            if res is not None:
                return
            self.step()
            if self._all_remote():
                time.sleep(self.poll_s)
        raise TimeoutError(
            f"request {request_id} did not finish in {max_steps} "
            "steps of streaming")

    def _all_remote(self) -> bool:
        with obs.held(self._lock):
            return all(getattr(m.replica, "remote", False)
                       for m in self._members.values()) \
                and bool(self._members)

    def begin_shutdown(self) -> None:
        """Stop admission (enqueue raises :class:`EngineClosed`;
        EngineClosed wins the race with an in-flight enqueue — the
        engine contract, one level up)."""
        with obs.held(self._lock):
            self._closed = True

    def shutdown(self, max_steps: int | None = None) -> dict:
        """Drain-then-shutdown: stop admission, pump until every
        accepted request is terminal (or ``max_steps`` trips —
        stragglers get structured ``"cancelled"`` results), and return
        all results.  Replica objects are left open: the router does
        not own their lifecycle."""
        self.begin_shutdown()
        steps = 0
        while True:
            with obs.held(self._lock):
                live = bool(self._requests)
            if not live:
                break
            if max_steps is not None and steps >= max_steps:
                break
            self.step()
            steps += 1
            if self._all_remote():
                time.sleep(self.poll_s)
        with obs.held(self._lock):
            for req in list(self._requests.values()):
                self._finish_locked(req, req.prompt, "cancelled",
                                    req.prompt.size)
            self._pending = []
        self._drain_unpins()
        return self.results()


# ------------------------------------------------------- the endpoint


class EngineEndpoint:
    """Serve one engine's admission surface over HTTP — the remote
    half of :class:`HttpReplica` (stdlib ``ThreadingHTTPServer``; the
    handlers touch the engine only through its locked admission surface:
    ``enqueue``, ``poll``, ``partial``, ``export_blocks``,
    ``import_blocks``, ``unpin_prefix`` and ``residency``).

    ================  ====================================================
    route             serves
    ================  ====================================================
    ``POST /enqueue``  ``{"prompt": [...], "max_new_tokens": n, ...}``
                       -> ``{"request_id": id}``; 429 = QueueFull
                       (backpressure), 503 = EngineClosed, 400 =
                       validation error
    ``GET /poll?id=``  the terminal ``RequestResult`` as JSON, or 404
                       while the request decodes
    ``GET /stream?id=`` the LIVE transcript snapshot (``partial()`` —
                       non-terminal ``queued``/``decoding`` statuses
                       included), 404 for unknown ids — the streaming
                       relay's read
    ``POST /prefill``  ``{"prompt": [...]}`` -> the prompt's full-block
                       KV run as a binary block shipment
                       (:func:`~distkeras_tpu_torch.serving.disagg.encode_shipment`);
                       429 = allocator backpressure, 400 = not a paged
                       engine / bad prompt
    ``POST /blocks``   a binary block shipment -> the adoption dict
                       (``{"prefix_id", "blocks", "hits", "bytes"}``);
                       429 = no free block (caller falls back), 400 =
                       malformed/geometry mismatch
    ``POST /unpin``    ``{"prefix_id": id}`` releases a shipped pin;
                       404 = unknown pin
    ``GET /residency`` the engine's residency digest (stem hashes,
                       prefix ids, block, live load — plus the
                       endpoint's ``role`` label) — the router's
                       affinity/load source
    ``GET /healthz``   200 while the engine admits, 503 once closed
    ================  ====================================================

    ``start(step=True)`` also runs the decode loop on a daemon thread
    (the replica-process deployment shape).  When the ``DKT_CLUSTER_*``
    env contract is present (or ``coord_dir=`` is given), the bound
    address publishes to ``<coord_dir>/serve/host<N>.addr`` for
    :func:`discover_replicas` — the same ledger pattern as telemetry
    federation.  ``role=`` labels the replica for the router's
    disaggregated topology (published in the address record, so
    discovery builds role-labeled handles).
    """

    def __init__(self, engine, *, port: int = 0,
                 bind: str = "127.0.0.1", coord_dir: str | None = None,
                 host_id: int | None = None, rid_base: int | None = None,
                 role: str | None = None):
        import os

        self.engine = engine
        self.role = _check_role(role)
        self._want_port = port
        self._bind = bind
        env = os.environ
        if coord_dir is None and "DKT_CLUSTER_DIR" in env:
            coord_dir = env["DKT_CLUSTER_DIR"]
        if host_id is None:
            host_id = int(env.get("DKT_CLUSTER_HOST", "0"))
        self.coord_dir = coord_dir
        self.host_id = host_id
        if rid_base is None:
            rid_base = (host_id + 1) * RID_SPAN
        if engine._next_id < rid_base:
            engine._next_id = rid_base
        self.port = None
        self._httpd = None
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()

    # ---------------------------------------------------------- serve

    def start(self, step: bool = True,
              idle_s: float = 0.005) -> "EngineEndpoint":
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)
        from urllib.parse import parse_qs, urlparse

        endpoint = self

        class Handler(BaseHTTPRequestHandler):
            # The engine wire protocol: every route, query param and
            # status code here is the reference's, as
            # scripts/obs_schema.json lists them.
            server_version = "dkt-engine/1.0"

            def log_message(self, *a):  # pragma: no cover — quiet
                pass

            def _send_raw(self, code, data, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _send(self, code, obj):
                self._send_raw(
                    code, json.dumps(obj, default=_jsonable).encode(),
                    "application/json")

            def do_GET(self):  # noqa: N802 — http.server API
                url = urlparse(self.path)
                try:
                    if url.path == "/poll":
                        q = parse_qs(url.query)
                        rid = int(q.get("id", ["-1"])[0])
                        res = endpoint.engine.poll(rid)
                        if res is None:
                            self._send(404, {"pending": rid})
                        else:
                            self._send(200, _result_doc(res))
                    elif url.path == "/stream":
                        q = parse_qs(url.query)
                        rid = int(q.get("id", ["-1"])[0])
                        res = endpoint.engine.partial(rid)
                        if res is None:
                            self._send(404, {"unknown": rid})
                        else:
                            self._send(200, _result_doc(res))
                    elif url.path == "/residency":
                        doc = dict(endpoint.engine.residency())
                        if endpoint.role is not None:
                            doc["role"] = endpoint.role
                        self._send(200, doc)
                    elif url.path == "/healthz":
                        ok = not endpoint.engine.closed
                        self._send(200 if ok else 503, {"ok": ok})
                    else:
                        self._send(404, {"error": f"unknown "
                                         f"{url.path}"})
                except BrokenPipeError:  # pragma: no cover
                    pass
                except Exception as e:  # noqa: BLE001 — keep serving
                    try:
                        self._send(500,
                                   {"error": f"{type(e).__name__}: "
                                             f"{e}"})
                    except Exception:  # pragma: no cover
                        pass

            def _post_enqueue(self, raw):
                body = json.loads(raw or b"{}")
                prompt = np.asarray(body.pop("prompt"), np.int32)
                max_new = int(body.pop("max_new_tokens"))
                try:
                    rid = endpoint.engine.enqueue(prompt, max_new,
                                                  **body)
                except QueueFull as e:
                    self._send(429, {"error": str(e)})
                    return
                except EngineClosed as e:
                    self._send(503, {"error": str(e)})
                    return
                except (ValueError, KeyError) as e:
                    self._send(400, {"error": str(e)})
                    return
                self._send(200, {"request_id": rid})

            def _post_prefill(self, raw):
                body = json.loads(raw or b"{}")
                prompt = np.asarray(body["prompt"], np.int32)
                try:
                    ship = endpoint.engine.export_blocks(prompt)
                except EngineClosed as e:
                    self._send(503, {"error": str(e)})
                    return
                except RuntimeError as e:  # allocator full
                    self._send(429, {"error": str(e)})
                    return
                except (ValueError, KeyError, AttributeError) as e:
                    # Not a paged engine / bad prompt geometry.
                    self._send(400, {"error": str(e)})
                    return
                self._send_raw(200, encode_shipment(ship),
                               "application/octet-stream")

            def _post_blocks(self, raw):
                try:
                    out = endpoint.engine.import_blocks(
                        decode_shipment(raw))
                except EngineClosed as e:
                    self._send(503, {"error": str(e)})
                    return
                except (ValueError, AttributeError) as e:
                    self._send(400, {"error": str(e)})
                    return
                if out is None:
                    self._send(429, {"error": "allocator "
                                     "backpressure: no free block "
                                     "for adoption"})
                    return
                self._send(200, out)

            def _post_unpin(self, raw):
                body = json.loads(raw or b"{}")
                try:
                    endpoint.engine.unpin_prefix(
                        int(body["prefix_id"]))
                except KeyError as e:
                    self._send(404, {"error": str(e)})
                    return
                self._send(200, {"ok": True})

            def do_POST(self):  # noqa: N802 — http.server API
                url = urlparse(self.path)
                routes = {"/enqueue": self._post_enqueue,
                          "/prefill": self._post_prefill,
                          "/blocks": self._post_blocks,
                          "/unpin": self._post_unpin}
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    raw = self.rfile.read(n)
                    handler = routes.get(url.path)
                    if handler is None:
                        self._send(404, {"error": f"unknown "
                                         f"{url.path}"})
                        return
                    handler(raw)
                except BrokenPipeError:  # pragma: no cover
                    pass
                except Exception as e:  # noqa: BLE001 — keep serving
                    try:
                        self._send(500,
                                   {"error": f"{type(e).__name__}: "
                                             f"{e}"})
                    except Exception:  # pragma: no cover
                        pass

        if self._httpd is not None:
            raise RuntimeError("endpoint already started")
        self._httpd = ThreadingHTTPServer((self._bind, self._want_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        t = threading.Thread(target=self._httpd.serve_forever,
                             kwargs={"poll_interval": 0.2},
                             name="dkt-engine-endpoint", daemon=True)
        t.start()
        self._threads.append(t)
        if step:
            s = threading.Thread(target=self._step_loop,
                                 args=(idle_s,),
                                 name="dkt-engine-step", daemon=True)
            s.start()
            self._threads.append(s)
        self._publish_addr()
        return self

    def _step_loop(self, idle_s: float) -> None:
        while not self._stop.is_set():
            eng = self.engine
            if eng.running() or eng.queued:
                try:
                    eng.step()
                except Exception:  # noqa: BLE001 — a step crash must
                    self._stop.wait(idle_s)  # not spin the thread hot
            else:
                self._stop.wait(idle_s)

    @property
    def addr(self) -> str:
        return f"{self._bind}:{self.port}"

    def _publish_addr(self) -> None:
        import os

        if self.coord_dir is None:
            return
        d = os.path.join(self.coord_dir, "serve")
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".addr.{self.host_id}.{os.getpid()}.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"host": self.host_id, "addr": self.addr,
                       "pid": os.getpid(), "role": self.role}, f)
        os.replace(tmp, os.path.join(d, f"host{self.host_id}.addr"))

    def _unpublish_addr(self) -> None:
        import os

        if self.coord_dir is None:
            return
        try:
            os.remove(os.path.join(self.coord_dir, "serve",
                                   f"host{self.host_id}.addr"))
        except OSError:
            pass

    def stop(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        self._unpublish_addr()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def _result_doc(res: RequestResult) -> dict:
    return {"request_id": int(res.request_id),
            "tokens": np.asarray(res.tokens, np.int32).tolist(),
            "status": res.status,
            "prompt_len": int(res.prompt_len), "error": res.error}


def _jsonable(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, np.generic):
        return o.item()
    return str(o)


__all__ = ["Router", "InProcessReplica", "HttpReplica",
           "EngineEndpoint", "ReplicaUnreachable", "discover_replicas",
           "RID_SPAN"]
