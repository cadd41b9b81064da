"""Rolling-window SLO engine over the metrics registry.

The port's copy of ``distkeras_tpu/obs/slo.py``.  The live half of the latency story: the registry's histograms are
*cumulative* (counts since the session started), which is the right
wire format for Prometheus but the wrong signal for an operator or an
autoscaler — "p99 since boot" hides a spike that started a minute ago.
This module runs a background **ticker** that snapshots every tracked
histogram, keeps a short ring of timestamped snapshots, and diffs the
newest against the one a window ago to produce **time-windowed
percentile gauges**::

    slo.windowed{metric="serving.request_s", q="p99"}  0.041

for the default watch list (TTFT / TPOT / `serving.request_s` /
`serving.queue_wait_s` / `train.step_s`) plus any metric named by a
rule.  Declarative :class:`SloRule`\\ s are evaluated on the same tick:

    SloRule("serving.request_s", percentile=0.99,
            threshold=0.250, window_s=30.0)

A rule whose windowed percentile crosses its threshold **breaches**:
one `slo.breach` obs event + a `slo.breaches{metric}` counter
increment on the ok->breach transition (edge-triggered — a sustained
breach is one event, re-armed when the window recovers), and every
subscriber callback fires with ``(rule, value)``.  The callback is the
quantitative load/latency signal the rest of the stack can consume —
e.g. the router's ``breach_demoter`` or the autoscaler's
``on_breach``.  The ticker (thread ``dkt-slo-tick``) only reads
registry snapshots; the clock is injectable, so tests tick by hand.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from distkeras_tpu_torch.obs.metrics import windowed_percentiles
from distkeras_tpu_torch.utils.locks import TracedLock, assert_unlocked

# Histograms the ticker windows even without a rule naming them — the
# serving fast path's user-facing latencies plus the training step.
DEFAULT_SLO_METRICS = ("serving.ttft_s", "serving.tpot_s",
                       "serving.request_s", "serving.queue_wait_s",
                       "train.step_s")


@dataclasses.dataclass(frozen=True)
class SloRule:
    """One declarative objective: "the ``percentile`` of ``metric``
    over the trailing ``window_s`` seconds stays under ``threshold``".

    ``metric`` names a registry histogram (all label sets of the name
    are aggregated — an SLO is about the workload, not one series);
    ``percentile`` is a quantile in (0, 1]; ``threshold`` is in the
    metric's own unit (seconds for the ``*_s`` conventions).

    ``replica``: the serving-fleet replica this rule is
    scoped to.  Pure label plumbing — evaluation is unchanged — but
    every ``slo.breach`` event and subscriber callback for the rule
    carries it, so a fleet-level consumer
    (:meth:`~distkeras_tpu_torch.serving.router.Router.breach_demoter`) can
    demote the RIGHT replica without a hand-built closure per replica;
    :meth:`Router.slo_rules` stamps one copy per attached replica."""

    metric: str
    percentile: float
    threshold: float
    window_s: float = 30.0
    replica: str | None = None

    def __post_init__(self):
        if not 0.0 < self.percentile <= 1.0:
            raise ValueError(
                f"percentile must be in (0, 1], got {self.percentile}")
        if self.threshold <= 0:
            raise ValueError(
                f"threshold must be > 0, got {self.threshold}")
        if self.window_s <= 0:
            raise ValueError(
                f"window_s must be > 0, got {self.window_s}")

    @property
    def q_label(self) -> str:
        return f"p{int(round(self.percentile * 100))}"


class SloEngine:
    """The rolling-window ticker (see module docstring).

    ``registry``: the live :class:`~distkeras_tpu_torch.obs.metrics.
    MetricsRegistry` to window; ``rules``: :class:`SloRule`\\ s;
    ``emit``: an event sink ``emit(name, **fields)`` (the obs session
    passes its trace-event hook) — optional; breaches always reach the
    counter and the subscribers.  ``clock`` is injectable so tests
    tick deterministically; :meth:`tick` is public for the same
    reason (the background thread just calls it every ``tick_s``).

    The engine's emissions (``slo.breaches``/``slo.windowed``/the
    ``slo.breach`` event) are the reference's, as
    ``scripts/obs_schema.json`` lists them — the autoscaler's input
    contract.
    """

    def __init__(self, registry, rules=(), *, tick_s: float = 1.0,
                 metrics=None, percentiles=(0.5, 0.95, 0.99),
                 emit=None, clock=time.monotonic):
        if tick_s <= 0:
            raise ValueError(f"tick_s must be > 0, got {tick_s}")
        self.registry = registry
        self.rules = tuple(rules)
        self.tick_s = tick_s
        self.percentiles = tuple(percentiles)
        self._emit = emit
        self._clock = clock
        watch = (DEFAULT_SLO_METRICS if metrics is None
                 else tuple(metrics))
        self.metrics = tuple(dict.fromkeys(
            list(watch) + [r.metric for r in self.rules]))
        # Ring of (t, {metric: aggregated-series snapshot}); pruned to
        # the longest window any consumer needs.
        self._ring: list[tuple[float, dict]] = []
        self._keep_s = max([r.window_s for r in self.rules]
                           + [30.0]) * 2.0
        self._breached: dict[int, bool] = {}
        self._subscribers: list = []
        # Guards the ring/breach state and the subscriber list; the
        # registry lock nests INSIDE it (_aggregate -> snapshot).
        # Subscriber callbacks always fire with it RELEASED (a
        # subscriber may call back into the engine;
        # locks.assert_unlocked pins it).
        self._lock = TracedLock("obs.slo")
        self._stop = threading.Event()
        self._thread = None
        self.last_values: dict[tuple[str, str], float] = {}

    # ---------------------------------------------------------- wiring

    def subscribe(self, fn) -> None:
        """Register ``fn(rule, value)`` to fire on every ok->breach
        transition.  Called from the ticker thread with the engine
        lock RELEASED, so the callback may query the engine
        (``windowed()``) or block — it only delays later ticks, never
        deadlocks them.  Registration itself takes the lock, so a
        subscribe racing a tick is ordered, not torn."""
        with self._lock:
            self._subscribers.append(fn)

    # ------------------------------------------------------------ ticks

    def _aggregate(self) -> dict:
        """One cumulative snapshot per watched metric, label sets
        summed (bucket edges are shared per instrument, so counts add
        elementwise)."""
        snap = self.registry.snapshot()
        out = {}
        for name in self.metrics:
            m = snap.get(name)
            if m is None or m.get("kind") != "histogram":
                continue
            agg = None
            for s in m["series"]:
                if agg is None:
                    agg = {"count": s["count"], "sum": s["sum"],
                           "buckets": list(s["buckets"]),
                           "counts": list(s["counts"])}
                else:
                    agg["count"] += s["count"]
                    agg["sum"] += s["sum"]
                    agg["counts"] = [a + b for a, b in
                                     zip(agg["counts"], s["counts"])]
            if agg is not None:
                out[name] = agg
        return out

    def _baseline(self, now: float, window_s: float) -> dict | None:
        """The newest ring entry at least ``window_s`` old (the window
        start).  None when the engine is younger than one window:
        everything observed so far IS inside the window, so the diff
        degenerates to the cumulative view — correct, not a fallback."""
        base = None
        for t, snap in self._ring:
            if now - t >= window_s:
                base = snap
            else:
                break
        return base

    def windowed(self, metric: str, percentile: float,
                 window_s: float) -> float | None:
        """The current windowed percentile for ``metric`` (None when
        the window saw no observations)."""
        with self._lock:
            now = self._clock()
            cur = self._aggregate().get(metric)
            if cur is None:
                return None
            base = self._baseline(now, window_s)
            base = None if base is None else base.get(metric)
            win = windowed_percentiles(cur, base, qs=(percentile,))
            if win is None:
                return None
            return win[f"p{int(round(percentile * 100))}"]

    def tick(self) -> dict:
        """One evaluation pass: window every watched metric into
        ``slo.windowed`` gauges, evaluate every rule, emit breaches.
        Returns ``{(metric, q): value}`` for the default window (the
        gauges' view) — public so tests and callers can
        drive the engine deterministically.

        Breach events and subscriber callbacks fire AFTER the engine
        lock is released, so a subscriber may freely call back into
        the engine (``windowed()``) or block without wedging the
        ticker."""
        with self._lock:
            values, fired = self._tick_locked()
            subscribers = list(self._subscribers)
        if fired:
            # The lock-sanitizer guard: breach events and subscriber
            # callbacks MUST fire with the engine lock released (a
            # subscriber that calls windowed() would deadlock).
            assert_unlocked("slo.breach subscribers")
        for rule, value in fired:
            if self._emit is not None:
                labels = ({"replica": rule.replica}
                          if rule.replica is not None else {})
                self._emit("slo.breach", metric=rule.metric,
                           q=rule.q_label, value=value,
                           threshold=rule.threshold,
                           window_s=rule.window_s, **labels)
            for fn in subscribers:
                try:
                    fn(rule, value)
                except Exception:  # noqa: BLE001 — a subscriber
                    pass           # must not kill the ticker
        return values

    def _tick_locked(self) -> tuple:
        now = self._clock()
        cur = self._aggregate()
        # Gauges: the default 30s window over every watched metric.
        gauge = self.registry.gauge(
            "slo.windowed", "rolling-window percentile (SLO engine)")
        values: dict = {}
        base_default = self._baseline(now, 30.0)
        for name, agg in cur.items():
            old = None if base_default is None \
                else base_default.get(name)
            win = windowed_percentiles(agg, old, qs=self.percentiles)
            if win is None:
                continue
            for q in self.percentiles:
                lab = f"p{int(round(q * 100))}"
                values[(name, lab)] = win[lab]
                gauge.set(win[lab], metric=name, q=lab)
        # Rules: each on ITS window.  Breach notifications are only
        # COLLECTED here; tick() fires them outside the lock.
        fired = []
        for i, rule in enumerate(self.rules):
            base = self._baseline(now, rule.window_s)
            old = None if base is None else base.get(rule.metric)
            agg = cur.get(rule.metric)
            value = None
            if agg is not None:
                win = windowed_percentiles(agg, old,
                                           qs=(rule.percentile,))
                if win is not None:
                    value = win[rule.q_label]
            breached = value is not None and value > rule.threshold
            if breached and not self._breached.get(i):
                labels = ({"replica": rule.replica}
                          if rule.replica is not None else {})
                self.registry.counter(
                    "slo.breaches",
                    "ok->breach transitions per SLO rule").inc(
                        metric=rule.metric, q=rule.q_label, **labels)
                fired.append((rule, value))
            self._breached[i] = breached
        # Ring maintenance: append, prune beyond the longest window.
        self._ring.append((now, cur))
        cutoff = now - self._keep_s
        while len(self._ring) > 1 and self._ring[1][0] <= cutoff:
            self._ring.pop(0)
        self.last_values = values
        return values, fired

    # ---------------------------------------------------------- thread

    def start(self) -> "SloEngine":
        if self._thread is not None:
            raise RuntimeError("SLO engine already started")

        def run():
            while not self._stop.wait(self.tick_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — a torn tick must
                    pass           # not kill telemetry for the run

        self._thread = threading.Thread(target=run, name="dkt-slo-tick",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


__all__ = ["SloRule", "SloEngine", "DEFAULT_SLO_METRICS"]
