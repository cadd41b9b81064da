"""Offline run reports from obs traces.

The port's copy of ``distkeras_tpu/obs/report.py``.

A trace JSONL (obs/trace.py) reconstructs into:

* **phase breakdown** — spans aggregated by name: call count, total /
  mean seconds, p50/p95/p99 of the span durations, share of the run's
  wall span;
* **latency percentiles** — every histogram series in the trace's
  final ``metrics`` record, rendered with bucket-interpolated
  p50/p95/p99 (obs/metrics.percentile_from_buckets);
* **counters/gauges** — the remaining metrics series;
* **event timeline** — point events in time order (chaos faults,
  supervisor attempts, admission rejects...).

``compare`` diffs two reports for regression triage: per-phase total /
mean deltas, histogram percentile deltas, counter deltas.
"""

from __future__ import annotations

import statistics

from distkeras_tpu_torch.obs.metrics import percentile_from_buckets
from distkeras_tpu_torch.obs.trace import read_trace


def _pct(durs: list, q: float) -> float:
    if not durs:
        return 0.0
    s = sorted(durs)
    idx = min(len(s) - 1, max(0, round(q * (len(s) - 1))))
    return s[int(idx)]


def build_report(records: list[dict]) -> dict:
    """Trace records -> plain-dict report (JSON-able)."""
    meta = next((r for r in records if r.get("kind") == "meta"), {})
    spans: dict[str, list] = {}
    events = []
    metrics = {}
    t_lo = t_hi = None
    for r in records:
        kind = r.get("kind")
        if kind == "span":
            spans.setdefault(r["name"], []).append(r)
            lo, hi = r["t0"], r["t0"] + r["dur"]
        elif kind == "event":
            events.append(r)
            lo = hi = r["t"]
        elif kind == "metrics":
            metrics = r.get("data", {})
            continue
        else:
            continue
        t_lo = lo if t_lo is None else min(t_lo, lo)
        t_hi = hi if t_hi is None else max(t_hi, hi)
    wall = (t_hi - t_lo) if t_lo is not None else 0.0

    phases = {}
    for name, recs in sorted(spans.items()):
        durs = [r["dur"] for r in recs]
        total = sum(durs)
        phases[name] = {
            "count": len(durs), "total_s": total,
            "mean_s": total / len(durs),
            "p50_s": statistics.median(durs),
            "p95_s": _pct(durs, 0.95), "p99_s": _pct(durs, 0.99),
            "share": (total / wall) if wall else 0.0,
        }

    hists, scalars = {}, {}
    for name, m in sorted(metrics.items()):
        for s in m.get("series", []):
            lab = ",".join(f"{k}={v}"
                           for k, v in sorted(s["labels"].items()))
            key = f"{name}{{{lab}}}" if lab else name
            if m.get("kind") == "histogram":
                if s.get("count"):
                    hists[key] = {
                        "count": s["count"],
                        "mean": s["sum"] / s["count"],
                        "min": s.get("min"), "max": s.get("max"),
                        "p50": percentile_from_buckets(s, 0.50),
                        "p95": percentile_from_buckets(s, 0.95),
                        "p99": percentile_from_buckets(s, 0.99),
                    }
            else:
                scalars[key] = s.get("value")

    timeline = [{"t": (e["t"] - t_lo) if t_lo is not None else e["t"],
                 "name": e["name"], "fields": e.get("fields", {})}
                for e in sorted(events, key=lambda e: e["t"])]
    return {"meta": {k: meta.get(k) for k in
                     ("run", "host", "pid", "time_unix")},
            "wall_s": wall, "phases": phases, "latency": hists,
            "scalars": scalars, "timeline": timeline}


def load_report(path: str) -> dict:
    return build_report(read_trace(path))


# --------------------------------------------------- request waterfall


def request_waterfall(records: list[dict], request_id: int) -> dict:
    """One serving request's life, reconstructed from its trace
    records (everything carrying ``request_id`` in its fields —
    round-11 per-request propagation): ``serving.submit`` ->
    ``serving.admit`` span (queue wait) -> ``serving.admit_chunk``
    spans (chunked prefill) -> ``serving.emit`` events (decode; the
    inter-token gaps) -> ``serving.finish``.

    **Routed requests**: when ``request_id`` is a
    fleet-wide router id, its ``router.route`` events name the
    replica-local ids each hop admitted under, and the waterfall
    follows them — the routing decision, any ``router.reroute`` hop,
    and every replica's engine-side stages render as ONE story (pass
    the MERGED records of all hosts' traces for a cross-process
    fleet; :func:`merge_traces` builds them).

    Returns a plain dict: ``{"request_id", "found", "submit_t",
    "stages": [{"t", "name", "dur", ...}], "queue_wait_s", "ttft_s",
    "total_s", "status", "tokens", "reroutes", "gaps": {...}}`` with
    every ``t`` relative to the submit event (or the earliest record
    seen)."""
    # Follow router hops first: replica-local ids this fleet-wide id
    # was admitted under, each tagged with its replica name.
    ids: dict = {request_id: None}
    final_id = request_id
    for r in records:
        if r.get("kind") != "event" or r.get("name") != "router.route":
            continue
        f = r.get("fields") or {}
        if f.get("request_id") != request_id:
            continue
        rrid = f.get("replica_request_id")
        if rrid is not None:
            ids[rrid] = f.get("replica")
            final_id = rrid
    mine_events, mine_spans = [], []
    for r in records:
        fields = r.get("fields") or {}
        rid = fields.get("request_id")
        if rid not in ids:
            continue
        tagged = dict(r)
        if ids[rid] is not None:
            tagged["_replica"] = ids[rid]
        if r.get("kind") == "event":
            mine_events.append(tagged)
        elif r.get("kind") == "span":
            mine_spans.append(tagged)
    if not mine_events and not mine_spans:
        return {"request_id": request_id, "found": False}

    def at(r):
        return r["t"] if r.get("kind") == "event" else r["t0"]

    def tag(stage, rec):
        if rec.get("_replica") is not None:
            stage["replica"] = rec["_replica"]
        return stage

    submit = next((e for e in mine_events
                   if e["name"] in ("router.submit",
                                    "serving.submit")), None)
    t0 = at(submit) if submit else min(at(r) for r in
                                       mine_events + mine_spans)
    stages = []
    for sp in mine_spans:
        stages.append(tag({"t": sp["t0"] - t0, "name": sp["name"],
                           "dur_s": sp["dur"], **{
                               k: v for k, v in sp["fields"].items()
                               if k != "request_id"}}, sp))
    emits = sorted((e for e in mine_events
                    if e["name"] == "serving.emit"),
                   key=lambda e: e["t"])
    for e in emits:
        stages.append(tag({"t": e["t"] - t0, "name": "serving.emit",
                           "n": e["fields"].get("n"),
                           "first": e["fields"].get("first")}, e))
    # Router hops: the routing decision(s), any re-route, and the
    # disaggregated block-transfer hop render as first-class stages
    # (rounds 13 and 17).
    hops = [e for e in mine_events
            if e["name"] in ("router.route", "router.reroute",
                             "router.block_transfer",
                             "router.finish")]
    for e in hops:
        stages.append({"t": e["t"] - t0, "name": e["name"],
                       **{k: v for k, v in e["fields"].items()
                          if k != "request_id"}})
    finishes = sorted((e for e in mine_events
                       if e["name"] == "serving.finish"),
                      key=lambda e: e["t"])
    for e in finishes:
        stages.append(tag({"t": e["t"] - t0, "name": "serving.finish",
                           "status": e["fields"].get("status")}, e))
    stages.sort(key=lambda s: s["t"])

    admit = next((sp for sp in mine_spans
                  if sp["name"] == "serving.admit"), None)
    # Token/gap accounting over the FINAL hop only: a rerouted
    # request re-decodes from scratch on its new replica, and the
    # caller-visible transcript is the final hop's.
    final_emits = [e for e in emits
                   if (e["fields"].get("request_id",
                                       request_id)) == final_id] \
        if len(ids) > 1 else emits
    gaps = [b["t"] - a["t"]
            for a, b in zip(final_emits, final_emits[1:])]
    gapstats = None
    if gaps:
        s = sorted(gaps)
        gapstats = {"count": len(gaps), "p50_s": statistics.median(s),
                    "max_s": s[-1]}
    finish = finishes[-1] if finishes else None
    status = finish["fields"].get("status") if finish else None
    if status is None:
        rf = next((e for e in hops if e["name"] == "router.finish"),
                  None)
        if rf is not None:
            status = rf["fields"].get("status")
    out = {
        "request_id": request_id, "found": True,
        "submit_t": t0,
        "prompt_len": (submit or {}).get("fields", {}).get(
            "prompt_len"),
        "queue_wait_s": (admit["t0"] - t0) if admit and submit
        else None,
        "ttft_s": (emits[0]["t"] - t0) if emits and submit else None,
        "prefill_chunks": sum(1 for sp in mine_spans
                              if sp["name"] == "serving.admit_chunk"),
        "tokens": sum(e["fields"].get("n") or 0 for e in final_emits),
        "reroutes": sum(1 for e in hops
                        if e["name"] == "router.reroute"),
        "status": status,
        "total_s": (finish["t"] - t0) if finish else None,
        "gaps": gapstats,
        "stages": stages,
    }
    return out


def render_waterfall(wf: dict) -> str:
    """Human-readable waterfall for one request."""
    rid = wf.get("request_id")
    if not wf.get("found"):
        return (f"request {rid}: no records carry request_id={rid} "
                "(was the trace written with a round-11+ engine?)")
    out = [f"request {rid}  prompt_len={wf.get('prompt_len')}  "
           f"status={wf.get('status')}  "
           f"total {_fmt_s(wf.get('total_s'))}"]
    out.append(
        f"  queue wait {_fmt_s(wf.get('queue_wait_s'))}   ttft "
        f"{_fmt_s(wf.get('ttft_s'))}   prefill chunks "
        f"{wf.get('prefill_chunks')}   tokens {wf.get('tokens')}")
    if wf.get("reroutes"):
        out.append(f"  re-route hops: {wf['reroutes']} (a replica "
                   "died or drained mid-request)")
    g = wf.get("gaps")
    if g:
        out.append(f"  inter-token gaps: {g['count']}  p50 "
                   f"{_fmt_s(g['p50_s'])}  max {_fmt_s(g['max_s'])}")
    out.append("\n== waterfall ==")
    for s in wf["stages"]:
        extra = " ".join(f"{k}={v}" for k, v in s.items()
                         if k not in ("t", "name", "dur_s"))
        dur = f"  [{_fmt_s(s['dur_s'])}]" if "dur_s" in s else ""
        out.append(f"  +{s['t']:>9.4f}s  {s['name']:<24}{dur}  {extra}")
    return "\n".join(out)


# ------------------------------------------------------ multi-host merge


def merged_records(paths) -> list[dict]:
    """Raw event/span records from SEVERAL traces, wall-clock aligned
    (each trace's monotonic ``t``/``t0`` rebased through its meta
    anchor, the :func:`merge_traces` alignment) — what
    :func:`request_waterfall` consumes when one request crossed
    processes (a routed fleet request: the router's trace plus each
    replica's).  Single-trace callers can keep passing ``read_trace``
    output; the relative timing math is identical."""
    out: list[dict] = []
    for path in paths:
        records = read_trace(path)
        meta = next((r for r in records if r.get("kind") == "meta"), {})
        off = 0.0
        if meta.get("time_unix") is not None \
                and meta.get("t") is not None:
            off = meta["time_unix"] - meta["t"]
        for r in records:
            if r.get("kind") == "span":
                out.append({**r, "t0": r["t0"] + off})
            elif r.get("kind") == "event":
                out.append({**r, "t": r["t"] + off})
            else:
                out.append(r)
    return out


def merge_traces(paths) -> dict:
    """Merge per-host trace files into ONE cross-host event timeline.

    Each trace's monotonic clock has its own epoch, so records are
    aligned through the meta record's wall anchor (``time_unix`` taken
    at the same instant as monotonic ``t``): ``wall = time_unix +
    (t - meta.t)``.  Every event keeps its source run id and host, so
    a coordinated-restart session — several runs per host, one file
    per attempt — reads as one story: fault events on the dying host,
    watchdog trips on the survivors, supervisor resumes in the next
    epoch, in true wall order.  NTP caveat: cross-host ordering is as
    good as the hosts' wall clocks (exact in the single-machine
    harness).

    Returns ``{"hosts": [...], "timeline": [...], "wall_s": float}``;
    timeline entries are ``{"t", "host", "run", "name", "fields"}``
    with ``t`` relative to the earliest event."""
    runs = []
    events = []
    for path in paths:
        records = read_trace(path)
        meta = next((r for r in records if r.get("kind") == "meta"), {})
        off = 0.0
        if meta.get("time_unix") is not None and meta.get("t") is not None:
            off = meta["time_unix"] - meta["t"]
        host = meta.get("host", 0)
        run = meta.get("run")
        n = 0
        for r in records:
            if r.get("kind") != "event":
                continue
            events.append({"wall": r["t"] + off, "host": host,
                           "run": run, "name": r["name"],
                           "fields": r.get("fields", {})})
            n += 1
        runs.append({"path": path, "run": run, "host": host,
                     "events": n, "pid": meta.get("pid")})
    events.sort(key=lambda e: e["wall"])
    t0 = events[0]["wall"] if events else 0.0
    timeline = [{"t": e["wall"] - t0, "host": e["host"], "run": e["run"],
                 "name": e["name"], "fields": e["fields"]}
                for e in events]
    wall = (events[-1]["wall"] - t0) if events else 0.0
    return {"hosts": runs, "timeline": timeline, "wall_s": wall}


def render_merged(rep: dict, max_events: int = 200) -> str:
    out = [f"merged {len(rep['hosts'])} trace(s), "
           f"wall {_fmt_s(rep['wall_s'])}"]
    for h in rep["hosts"]:
        out.append(f"  host {h['host']}  run {h['run']}  "
                   f"{h['events']} event(s)  {h['path']}")
    out.append("\n== cross-host event timeline ==")
    shown = rep["timeline"][:max_events]
    for e in shown:
        fields = " ".join(f"{k}={v}" for k, v in e["fields"].items())
        out.append(f"  +{e['t']:>9.4f}s  h{e['host']}  "
                   f"{e['name']:<28}{fields}")
    if len(rep["timeline"]) > len(shown):
        out.append(f"  ... {len(rep['timeline']) - len(shown)} more "
                   "event(s)")
    return "\n".join(out)


# ------------------------------------------------------------ rendering


def _fmt_s(v) -> str:
    if v is None:
        return "-"
    if v >= 1.0:
        return f"{v:.3f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    return f"{v * 1e6:.0f}us"


def _is_seconds(metric_name: str) -> bool:
    """Histogram naming convention: ``*_s`` series carry seconds (and
    render as latency); anything else renders as plain numbers."""
    return metric_name.split("{")[0].endswith("_s")


def _fmt_for(name: str):
    return _fmt_s if _is_seconds(name) else (
        lambda v: "-" if v is None else f"{v:.4g}")


def render_report(rep: dict, max_events: int = 60) -> str:
    out = [f"run {rep['meta'].get('run')}  host {rep['meta'].get('host')}"
           f"  wall {_fmt_s(rep['wall_s'])}"]
    if rep["phases"]:
        out.append("\n== phase breakdown (spans) ==")
        out.append(f"{'phase':<32}{'calls':>7}{'total':>10}{'mean':>10}"
                   f"{'p50':>10}{'p95':>10}{'p99':>10}{'share':>8}")
        for name, p in sorted(rep["phases"].items(),
                              key=lambda kv: -kv[1]["total_s"]):
            out.append(
                f"{name:<32}{p['count']:>7}{_fmt_s(p['total_s']):>10}"
                f"{_fmt_s(p['mean_s']):>10}{_fmt_s(p['p50_s']):>10}"
                f"{_fmt_s(p['p95_s']):>10}{_fmt_s(p['p99_s']):>10}"
                f"{p['share'] * 100:>7.1f}%")
    if rep["latency"]:
        out.append("\n== histograms (latency and sizes) ==")
        out.append(f"{'metric':<44}{'count':>7}{'mean':>12}{'p50':>12}"
                   f"{'p95':>12}{'p99':>12}")
        for name, h in sorted(rep["latency"].items()):
            fmt = _fmt_for(name)
            out.append(f"{name:<44}{h['count']:>7}{fmt(h['mean']):>12}"
                       f"{fmt(h['p50']):>12}{fmt(h['p95']):>12}"
                       f"{fmt(h['p99']):>12}")
    if rep["scalars"]:
        out.append("\n== counters / gauges ==")
        for name, v in sorted(rep["scalars"].items()):
            out.append(f"{name:<52}{v:>12g}")
    if rep["timeline"]:
        out.append("\n== event timeline ==")
        shown = rep["timeline"][:max_events]
        for e in shown:
            fields = " ".join(f"{k}={v}" for k, v in e["fields"].items())
            out.append(f"  +{e['t']:>9.4f}s  {e['name']:<28}{fields}")
        if len(rep["timeline"]) > len(shown):
            out.append(f"  ... {len(rep['timeline']) - len(shown)} more "
                       "event(s)")
    return "\n".join(out)


def _delta(old, new) -> str:
    if old is None or new is None:
        return "-"
    if not old:
        return "new" if new else "0"
    return f"{(new - old) / old * 100:+.1f}%"


def render_compare(base: dict, new: dict) -> str:
    """Human-readable regression diff: ``new`` against ``base``."""
    out = [f"compare: base run {base['meta'].get('run')} -> "
           f"new run {new['meta'].get('run')}",
           f"wall {_fmt_s(base['wall_s'])} -> {_fmt_s(new['wall_s'])} "
           f"({_delta(base['wall_s'], new['wall_s'])})"]
    names = sorted(set(base["phases"]) | set(new["phases"]))
    if names:
        out.append("\n== phases: total (mean) base -> new ==")
        for n in names:
            b, w = base["phases"].get(n), new["phases"].get(n)
            if b is None:
                out.append(f"{n:<32} ADDED    total {_fmt_s(w['total_s'])}")
            elif w is None:
                out.append(f"{n:<32} REMOVED  was {_fmt_s(b['total_s'])}")
            else:
                out.append(
                    f"{n:<32}{_fmt_s(b['total_s']):>10} ->"
                    f"{_fmt_s(w['total_s']):>10} "
                    f"({_delta(b['total_s'], w['total_s']):>7})   mean "
                    f"{_fmt_s(b['mean_s'])} -> {_fmt_s(w['mean_s'])} "
                    f"({_delta(b['mean_s'], w['mean_s'])})")
    names = sorted(set(base["latency"]) | set(new["latency"]))
    if names:
        out.append("\n== histograms: p50 / p95 / p99 base -> new ==")
        for n in names:
            b, w = base["latency"].get(n), new["latency"].get(n)
            if b is None or w is None:
                out.append(f"{n:<44} {'ADDED' if b is None else 'REMOVED'}")
                continue
            fmt = _fmt_for(n)
            out.append(
                f"{n:<44}"
                f"p50 {fmt(b['p50'])}->{fmt(w['p50'])} "
                f"({_delta(b['p50'], w['p50'])})  "
                f"p95 {fmt(b['p95'])}->{fmt(w['p95'])} "
                f"({_delta(b['p95'], w['p95'])})  "
                f"p99 {fmt(b['p99'])}->{fmt(w['p99'])} "
                f"({_delta(b['p99'], w['p99'])})")
    names = sorted(set(base["scalars"]) | set(new["scalars"]))
    if names:
        out.append("\n== counters / gauges base -> new ==")
        for n in names:
            b = base["scalars"].get(n)
            w = new["scalars"].get(n)
            out.append(f"{n:<52}{(b if b is not None else '-'):>10} -> "
                       f"{(w if w is not None else '-'):>10}")
    return "\n".join(out)


__all__ = ["build_report", "load_report", "render_report",
           "render_compare", "merge_traces", "merged_records",
           "render_merged", "request_waterfall", "render_waterfall"]
