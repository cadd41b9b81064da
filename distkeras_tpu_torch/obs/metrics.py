"""Process-wide metrics registry: counters, gauges, histograms.

The port's own copy of ``distkeras_tpu/obs/metrics.py``: every subsystem
records into ONE namespace, snapshot on demand, cheap enough for hot
loops.

* **Hot-loop cheap.**  An update is a dict lookup plus a float add under
  a lock that is uncontended on single-threaded paths (the *disabled*
  path is cheaper still: the ``obs`` facade returns on ``_ACTIVE is
  None`` before any registry is touched).
* **Labels.**  Every instrument takes ``**labels``; each distinct label
  set is its own series, keyed by the sorted ``(key, value)`` tuple.
* **Histograms** use fixed bucket edges chosen at creation (default:
  log-spaced latency edges), cumulative like Prometheus, so percentiles
  are estimable offline and two snapshots subtract cleanly.
* **Snapshot isolation.**  :meth:`MetricsRegistry.snapshot` returns plain
  dicts/lists decoupled from live state.

Exporters: :meth:`MetricsRegistry.render_text` (Prometheus text format),
:meth:`MetricsRegistry.compact`, and the JSONL ``metrics`` record the obs
session appends to its trace on close.
"""

from __future__ import annotations

import bisect
import re

from distkeras_tpu_torch.utils.locks import TracedLock

# Log-ish spaced seconds: 100us .. 2min.  Wide enough for h2d dispatch
# at the bottom and a whole chaos-suite drain at the top.
DEFAULT_TIME_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0)

# The exposition-format metric-name grammar (Prometheus text format).
_PROM_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")


def prom_name(name: str) -> str:
    """Registry name -> Prometheus exposition name (``.``/``-`` map to
    ``_``).  The mangling is lossy, so :class:`MetricsRegistry` rejects
    two distinct registry names that would collide on the wire at
    registration time (e.g. ``serving.queue_depth`` vs
    ``serving_queue_depth`` — one would silently alias the other on
    every scrape)."""
    return name.replace(".", "_").replace("-", "_")


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    """Base: one named metric, one child state per label set."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", registry=None):
        self.name = name
        self.help = help
        self._children: dict[tuple, object] = {}
        self._lock = registry._lock if registry is not None \
            else TracedLock("obs.metrics")

    def _child(self, labels: dict):
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def _new_child(self):  # pragma: no cover - subclasses override
        raise NotImplementedError

    def series(self) -> list[tuple[tuple, object]]:
        """[(label key, child state)] sorted by label key."""
        with self._lock:
            return sorted(self._children.items())


class Counter(_Instrument):
    """Monotonically increasing float per label set."""

    kind = "counter"

    def _new_child(self):
        return [0.0]

    def inc(self, n: float = 1.0, **labels) -> None:
        if n < 0:
            raise ValueError(f"counters only go up; got inc({n})")
        child = self._child(labels)
        with self._lock:
            child[0] += n

    def value(self, **labels) -> float:
        return self._children.get(_label_key(labels), [0.0])[0]


class Gauge(_Instrument):
    """Last-write-wins float per label set (plus inc/dec for levels)."""

    kind = "gauge"

    def _new_child(self):
        return [0.0]

    def set(self, value: float, **labels) -> None:
        child = self._child(labels)
        with self._lock:  # mixed set/inc from two threads must not
            child[0] = float(value)  # lose either update

    def inc(self, n: float = 1.0, **labels) -> None:
        child = self._child(labels)
        with self._lock:
            child[0] += n

    def dec(self, n: float = 1.0, **labels) -> None:
        self.inc(-n, **labels)

    def value(self, **labels) -> float:
        return self._children.get(_label_key(labels), [0.0])[0]


class _HistState:
    __slots__ = ("counts", "total", "count", "vmin", "vmax")

    def __init__(self, n_edges: int):
        self.counts = [0] * (n_edges + 1)  # +inf bucket last
        self.total = 0.0
        self.count = 0
        self.vmin = None
        self.vmax = None


class Histogram(_Instrument):
    """Fixed-bucket-edge distribution per label set.

    ``buckets`` are the inclusive upper edges (ascending); one extra
    implicit +inf bucket catches the tail.  ``observe`` is a bisect +
    two adds — hot-loop safe.  Percentiles are *estimated* offline by
    linear interpolation inside the winning bucket
    (:func:`percentile_from_buckets`), exact min/max are tracked
    alongside so the estimate is clamped to observed range.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple = DEFAULT_TIME_BUCKETS, registry=None):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(
                f"histogram buckets must be ascending and non-empty, "
                f"got {buckets}")
        super().__init__(name, help, registry=registry)
        self.buckets = tuple(float(b) for b in buckets)

    def _new_child(self):
        return _HistState(len(self.buckets))

    def observe(self, value: float, **labels) -> None:
        st = self._child(labels)
        with self._lock:
            st.counts[bisect.bisect_left(self.buckets, value)] += 1
            st.total += value
            st.count += 1
            if st.vmin is None or value < st.vmin:
                st.vmin = value
            if st.vmax is None or value > st.vmax:
                st.vmax = value


def percentile_from_buckets(snapshot: dict, q: float) -> float | None:
    """Estimate the ``q``-quantile (0..1) of one histogram-series
    snapshot (the dict :meth:`MetricsRegistry.snapshot` emits): find
    the bucket where the cumulative count crosses ``q * count`` and
    interpolate linearly inside it, clamped to the observed min/max.
    None when the series is empty."""
    count = snapshot.get("count", 0)
    if not count:
        return None
    edges = list(snapshot["buckets"])
    counts = list(snapshot["counts"])
    target = q * count
    lo_edge = snapshot.get("min") or 0.0
    cum = 0
    for i, c in enumerate(counts):
        nxt = cum + c
        if nxt >= target and c:
            lo = edges[i - 1] if i else min(lo_edge, edges[0])
            hi = edges[i] if i < len(edges) else (snapshot.get("max")
                                                  or edges[-1])
            frac = (target - cum) / c
            est = lo + (hi - lo) * frac
            if snapshot.get("min") is not None:
                est = max(est, snapshot["min"])
            if snapshot.get("max") is not None:
                est = min(est, snapshot["max"])
            return est
        cum = nxt
    return snapshot.get("max")


class MetricsRegistry:
    """One namespace of named instruments.

    ``counter`` / ``gauge`` / ``histogram`` get-or-create (re-asking
    for a name returns the same instrument; re-asking with a different
    kind raises — one name, one type).  ``snapshot()`` exports plain
    data; ``render_text()`` exports the Prometheus text format.
    """

    def __init__(self):
        # Leaf lock: every subsystem records INTO the registry while
        # holding its own lock; nothing is acquired under this one.
        self._lock = TracedLock("obs.registry")
        self._metrics: dict[str, _Instrument] = {}
        # prom_name -> registry name: the exposition mangling is lossy,
        # so a wire-name collision is detected HERE, at registration,
        # instead of silently interleaving two series on every scrape.
        self._prom_names: dict[str, str] = {}

    def _get(self, cls, name: str, help: str, **kw) -> _Instrument:
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    pname = prom_name(name)
                    if not _PROM_NAME_RE.match(pname):
                        raise ValueError(
                            f"metric name {name!r} does not map to a "
                            f"legal Prometheus name ({pname!r}); use "
                            "[a-zA-Z0-9_.:-] only")
                    other = self._prom_names.get(pname)
                    if other is not None and other != name:
                        raise ValueError(
                            f"metric {name!r} collides with {other!r} "
                            f"on the exposition name {pname!r} (the "
                            "./- -> _ mangling is lossy); rename one")
                    m = cls(name, help, registry=self, **kw)
                    self._prom_names[pname] = name
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_TIME_BUCKETS) -> Histogram:
        h = self._get(Histogram, name, help, buckets=buckets)
        if tuple(float(b) for b in buckets) != h.buckets:
            raise ValueError(
                f"histogram {name!r} already registered with edges "
                f"{h.buckets}; re-requested with {tuple(buckets)}")
        return h

    # ------------------------------------------------------- exporters

    def snapshot(self) -> dict:
        """``{name: {"kind", "help", "series": [{"labels", ...}]}}``,
        fully decoupled from live state (safe to mutate/serialize)."""
        out = {}
        with self._lock:
            metrics = list(self._metrics.items())
        for name, m in metrics:
            series = []
            for key, st in m.series():
                entry: dict = {"labels": dict(key)}
                if m.kind in ("counter", "gauge"):
                    entry["value"] = st[0]
                else:
                    entry.update(count=st.count, sum=st.total,
                                 min=st.vmin, max=st.vmax,
                                 buckets=list(m.buckets),
                                 counts=list(st.counts))
                series.append(entry)
            out[name] = {"kind": m.kind, "help": m.help, "series": series}
        return out

    def render_text(self) -> str:
        """Prometheus text exposition format (scrape-compatible:
        ``# HELP`` / ``# TYPE`` headers, ``_bucket``/``_sum``/
        ``_count`` histogram expansion, cumulative ``le`` buckets,
        escaped label values)."""
        def esc(v: str) -> str:
            return (v.replace("\\", "\\\\").replace('"', '\\"')
                     .replace("\n", "\\n"))

        def esc_help(v: str) -> str:
            # HELP text escapes backslash and line feed ONLY (the
            # text-format spec); a raw newline here would tear the
            # exposition stream mid-metric.
            return v.replace("\\", "\\\\").replace("\n", "\\n")

        lines = []
        for name, m in sorted(self.snapshot().items()):
            pname = prom_name(name)
            if m["help"]:
                lines.append(f"# HELP {pname} {esc_help(m['help'])}")
            lines.append(f"# TYPE {pname} {m['kind']}")
            for s in m["series"]:
                lab = ",".join(f'{k}="{esc(v)}"'
                               for k, v in sorted(s["labels"].items()))
                if m["kind"] in ("counter", "gauge"):
                    lines.append(f"{pname}{{{lab}}} {s['value']}"
                                 if lab else f"{pname} {s['value']}")
                else:
                    cum = 0
                    for edge, c in zip(s["buckets"] + [float("inf")],
                                       s["counts"]):
                        cum += c
                        le = ("+Inf" if edge == float("inf")
                              else repr(edge))
                        extra = f'{lab},le="{le}"' if lab \
                            else f'le="{le}"'
                        lines.append(f"{pname}_bucket{{{extra}}} {cum}")
                    suffix = f"{{{lab}}}" if lab else ""
                    lines.append(f"{pname}_sum{suffix} {s['sum']}")
                    lines.append(f"{pname}_count{suffix} {s['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def compact(self) -> dict:
        """Small JSON-able view for attaching to bench/CI artifacts:
        counters/gauges as ``{name{labels}: value}``, histograms as
        ``{count, mean, min, max, p50, p95, p99}`` — min/max are the
        EXACT observed extremes the snapshot already tracks, so bench
        rows and SLO summaries see true worst-case latency, not just
        the bucket-interpolated p99."""
        out = {}
        for name, m in sorted(self.snapshot().items()):
            for s in m["series"]:
                lab = ",".join(f"{k}={v}"
                               for k, v in sorted(s["labels"].items()))
                key = f"{name}{{{lab}}}" if lab else name
                if m["kind"] in ("counter", "gauge"):
                    out[key] = s["value"]
                elif s["count"]:
                    out[key] = {
                        "count": s["count"],
                        "mean": s["sum"] / s["count"],
                        "min": s["min"], "max": s["max"],
                        "p50": percentile_from_buckets(s, 0.50),
                        "p95": percentile_from_buckets(s, 0.95),
                        "p99": percentile_from_buckets(s, 0.99),
                    }
        return out


def windowed_percentiles(new: dict, old: dict | None,
                         qs=(0.5, 0.95, 0.99)) -> dict | None:
    """Percentiles of the observations that landed BETWEEN two
    histogram-series snapshots (the dicts :meth:`MetricsRegistry.
    snapshot` emits): subtract the cumulative bucket counts and
    interpolate on the difference.  ``old=None`` means "since the
    beginning".  Returns ``{"count", qs...}`` or None when the window
    saw nothing.  The exact min/max are cumulative, not windowed, so
    the estimate is deliberately NOT clamped to them."""
    counts = list(new["counts"])
    count = new.get("count", 0)
    if old is not None:
        counts = [a - b for a, b in zip(counts, old["counts"])]
        count -= old.get("count", 0)
    if count <= 0:
        return None
    diff = {"count": count, "counts": counts,
            "buckets": list(new["buckets"]), "min": None, "max": None}
    out = {"count": count}
    for q in qs:
        out[f"p{int(round(q * 100))}"] = percentile_from_buckets(diff, q)
    return out


__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "DEFAULT_TIME_BUCKETS", "percentile_from_buckets",
           "windowed_percentiles", "prom_name"]
