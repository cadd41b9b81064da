"""The port's live telemetry plane against the JAX package's.

Mirrors ``tests/test_obs_live.py``: the same registry contents render
the same Prometheus exposition BYTE for byte in both packages (and
parse under the reference tests' strict parser); the SLO engine's
windows, breaches and re-arms are the reference's tick for tick under
an injected clock; the port's ``TelemetryServer`` serves the six
routes, federates hosts through ``<coord_dir>`` address files and drops
a dead one; the trace tail tolerates a torn write; and the request
waterfall of a real port engine run renders every stage.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.obs.live import (HeartbeatHealth, TelemetryServer,
                                          merge_expositions)
from distkeras_tpu_torch.obs.metrics import (MetricsRegistry, prom_name,
                                             windowed_percentiles)
from distkeras_tpu_torch.obs.report import (render_waterfall,
                                            request_waterfall)
from distkeras_tpu_torch.obs.slo import SloEngine, SloRule
from distkeras_tpu_torch.obs.trace import read_trace, tail_trace
from distkeras_tpu_torch.resilience.health import write_beat
from distkeras_tpu.obs.metrics import windowed_percentiles as j_windowed
from tests.test_obs_live import parse_exposition
from tests.torch_fleet import PORT, REF, both, model


def get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8")


# -------------------------------------------- registry satellites


def test_exposition_conformance_and_label_roundtrip():
    def scenario(ns):
        reg = ns.MetricsRegistry()
        reg.counter("serving.requests", "total requests").inc(
            3, status="ok")
        reg.counter("serving.requests").inc(status='we"ird\\lab\nel')
        reg.gauge("queue.depth", "queued requests").set(2)
        reg.histogram("serving.request_s", "request latency").observe(
            0.03, status="ok")
        reg.histogram("serving.request_s").observe(7.0, status="timeout")
        return reg.render_text()

    text = both(scenario)                 # byte-identical exposition
    fams = parse_exposition(text)
    assert fams["serving_requests"]["type"] == "counter"
    assert fams["serving_requests"]["help"] == "total requests"
    weird = [lab for _, lab, _ in fams["serving_requests"]["samples"]]
    assert {"status": 'we"ird\\lab\nel'} in weird
    assert fams["serving_request_s"]["type"] == "histogram"


def test_help_text_newline_is_escaped():
    def scenario(ns):
        reg = ns.MetricsRegistry()
        reg.counter("a.b", "line one\nline two \\ slash").inc()
        return reg.render_text()

    text = both(scenario)
    assert "# HELP a_b line one\\nline two \\\\ slash" in text
    parse_exposition(text)


def test_wire_name_collision_raises_at_registration():
    reg = MetricsRegistry()
    reg.counter("serving.queue_depth").inc()
    with pytest.raises(ValueError, match="collides"):
        reg.counter("serving_queue_depth")
    with pytest.raises(ValueError, match="collides"):
        reg.gauge("serving-queue.depth")
    reg.counter("serving.queue_depth").inc()
    assert reg.counter("serving.queue_depth").value() == 2
    with pytest.raises(ValueError, match="legal Prometheus name"):
        reg.counter("bad name!")
    assert prom_name("a.b-c") == "a_b_c"


def test_compact_includes_exact_min_max():
    def scenario(ns):
        reg = ns.MetricsRegistry()
        h = reg.histogram("lat_s")
        for v in (0.003, 0.4, 11.0):
            h.observe(v)
        return reg.compact()["lat_s"]

    c = both(scenario)
    assert c["min"] == 0.003 and c["max"] == 11.0
    assert c["count"] == 3 and c["p99"] <= 11.0


def test_windowed_percentiles_diff():
    reg = MetricsRegistry()
    h = reg.histogram("lat_s")
    for _ in range(10):
        h.observe(0.01)
    old = reg.snapshot()["lat_s"]["series"][0]
    for _ in range(10):
        h.observe(5.0)
    new = reg.snapshot()["lat_s"]["series"][0]
    cum = windowed_percentiles(new, None)
    win = windowed_percentiles(new, old)
    assert win == j_windowed(new, old)
    assert win["count"] == 10 and cum["count"] == 20
    assert win["p50"] > 1.0 > cum["p50"]
    assert windowed_percentiles(old, old) is None


# ------------------------------------------------------- SLO engine


def test_slo_engine_windows_breaches_and_rearms():
    def scenario(ns):
        t = [0.0]
        events, hits, seen = [], [], []
        reg = ns.MetricsRegistry()
        eng = ns.SloEngine(
            reg, [ns.SloRule("lat_s", percentile=0.99, threshold=1.0,
                             window_s=10.0)],
            clock=lambda: t[0],
            emit=lambda name, **f: events.append((name, f)))
        # The subscriber queries the engine back: it fires with the
        # engine lock released, so this must not deadlock the tick.
        eng.subscribe(lambda rule, value: hits.append(
            (rule.metric, value, eng.windowed(rule.metric, 0.5, 10.0))))
        h = reg.histogram("lat_s")
        script = [(0.0, 5, 0.01), (5.0, 5, 5.0), (6.0, 0, 0.0),
                  (20.0, 20, 0.01), (21.0, 5, 5.0)]
        for now, n, v in script:
            t[0] = now
            for _ in range(n):
                h.observe(v)
            eng.tick()
            seen.append((len(events),
                         reg.counter("slo.breaches").value(
                             metric="lat_s", q="p99"),
                         eng.windowed("lat_s", 0.99, 10.0)))
        assert [e[0] for e in seen] == [0, 1, 1, 1, 2]
        assert events[0][1]["metric"] == "lat_s"
        assert events[0][1]["value"] > 1.0
        assert hits and hits[0][0] == "lat_s" and hits[0][2] is not None
        assert reg.gauge("slo.windowed").value(metric="lat_s",
                                               q="p99") > 1.0
        return seen, events, hits

    both(scenario)


def test_slo_rule_validation():
    for ns in (PORT, REF):
        with pytest.raises(ValueError, match="percentile"):
            ns.SloRule("m", percentile=1.5, threshold=1.0)
        with pytest.raises(ValueError, match="threshold"):
            ns.SloRule("m", percentile=0.99, threshold=0.0)
        with pytest.raises(ValueError, match="window_s"):
            ns.SloRule("m", percentile=0.99, threshold=1.0, window_s=-1)
    assert [r.__name__ for r in (SloRule, SloEngine)] == \
        ["SloRule", "SloEngine"]


# ------------------------------------------------- telemetry server


def test_server_endpoints_and_trace_tail(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with obs.session(trace_path=path, serve_port=0) as sess:
        obs.count("x.hits", 2, kind="a")
        obs.observe("x.lat_s", 0.02)
        for i in range(8):
            obs.event("marker", i=i)
        url = sess.server.url
        fams = parse_exposition(get(url + "/metrics"))
        assert ("x_hits", {"kind": "a"}, "2.0") in fams["x_hits"]["samples"]
        snap = json.loads(get(url + "/snapshot.json"))
        assert snap["x.hits"]["series"][0]["value"] == 2
        recs = [json.loads(x) for x in
                get(url + "/trace/tail?n=3").splitlines()]
        assert [r["fields"]["i"] for r in recs] == [5, 6, 7]
        with pytest.raises(urllib.error.HTTPError) as ei:
            get(url + "/nope")
        assert ei.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            get(url + "/residency")         # no engine attached
        assert ei.value.code == 404
    with pytest.raises(Exception):
        get(url + "/metrics", timeout=2)


def test_failed_start_closes_what_it_opened(tmp_path):
    """A live plane that cannot bind its port leaves no ticker thread,
    no open trace and no active session behind."""
    with TelemetryServer(MetricsRegistry()) as busy:
        with pytest.raises(OSError):
            obs.enable(trace_path=str(tmp_path / "t.jsonl"),
                       serve_port=busy.port)
    assert obs.active() is None
    assert not [t for t in threading.enumerate()
                if t.name.startswith("dkt-slo")]


def test_healthz_flips_with_heartbeat_freshness(tmp_path):
    t = [100.0]
    hb = str(tmp_path / "hb")
    health = HeartbeatHealth(hb, host=0, window=2.0, clock=lambda: t[0])
    with obs.session(serve_port=0, health=health) as sess:
        url = sess.server.url
        with pytest.raises(urllib.error.HTTPError) as ei:
            get(url + "/healthz")
        assert ei.value.code == 503
        write_beat(hb, 0, epoch=0, n=1, clock=lambda: t[0])
        body = json.loads(get(url + "/healthz"))
        assert body["ok"] and body["age_s"] <= 2.0
        # The reference's probe reads the same beat file the same way.
        ref = REF.live.HeartbeatHealth(hb, host=0, window=2.0,
                                       clock=lambda: t[0])
        assert ref() == health()
        t[0] += 10.0
        with pytest.raises(urllib.error.HTTPError) as ei:
            get(url + "/healthz")
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["ok"] is False
        write_beat(hb, 0, epoch=0, n=2, clock=lambda: t[0], done=True)
        t[0] += 100.0
        assert json.loads(get(url + "/healthz"))["done"] is True
        assert ref() == health()


def test_tail_trace_tolerates_live_torn_write(tmp_path):
    path = str(tmp_path / "x.jsonl")
    with open(path, "w") as f:
        for i in range(100):
            f.write(json.dumps({"kind": "event", "name": "e", "t": i,
                                "fields": {"i": i}}) + "\n")
        f.write('{"kind": "ev')
    recs = tail_trace(path, 5)
    assert [r["fields"]["i"] for r in recs] == [95, 96, 97, 98, 99]
    assert tail_trace(path, 0) == []
    assert len(tail_trace(path, 1000)) == 100
    assert tail_trace(path, 10, kinds=("span",)) == []


def test_scrape_under_concurrent_writes_no_torn_lines():
    reg = MetricsRegistry()
    stop = threading.Event()

    def writer(k):
        while not stop.is_set():
            reg.counter("w.requests").inc(status=f"s{k}")
            reg.histogram("w.lat_s").observe(0.01 * (k + 1), kind=f"k{k}")
            reg.gauge("w.depth").set(k, lane=str(k))

    threads = [threading.Thread(target=writer, args=(k,), daemon=True)
               for k in range(3)]
    with TelemetryServer(reg) as srv:
        for th in threads:
            th.start()
        t0 = time.monotonic()
        try:
            for _ in range(30):
                parse_exposition(get(srv.url + "/metrics"))
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=5.0)
        assert time.monotonic() - t0 < 60.0


# ------------------------------------------------------- federation


def test_cluster_federation_merges_hosts_and_drops_dead_peer(tmp_path):
    """Host 0 is the port's server, host 1 the reference's: federation
    is the address ledger and the exposition, so the two packages'
    servers federate with each other."""
    cdir = str(tmp_path / "coord")
    r0, r1 = MetricsRegistry(), REF.MetricsRegistry()
    r0.counter("serving.requests").inc(3, status="ok")
    r1.counter("serving.requests").inc(5, status="ok")
    r1.gauge("only.on.one").set(7)
    with TelemetryServer(r0, cluster_dir=cdir, host_id=0) as s0, \
            REF.live.TelemetryServer(r1, cluster_dir=cdir, host_id=1):
        fams = parse_exposition(get(s0.url + "/metrics/cluster"))
        sam = fams["serving_requests"]["samples"]
        assert ("serving_requests", {"host": "0", "status": "ok"},
                "3.0") in sam
        assert ("serving_requests", {"host": "1", "status": "ok"},
                "5.0") in sam
        up = {lab["host"]: v for _, lab, v in
              fams["cluster_scrape_up"]["samples"]}
        assert up == {"0": "1", "1": "1"}
        with open(os.path.join(cdir, "telemetry", "host7.addr"),
                  "w") as f:
            json.dump({"host": 7, "addr": "127.0.0.1:9"}, f)
        fams = parse_exposition(get(s0.url + "/metrics/cluster"))
        up = {lab["host"]: v for _, lab, v in
              fams["cluster_scrape_up"]["samples"]}
        assert up["7"] == "0"
        assert not any(lab.get("host") == "7" for _, lab, _ in
                       fams["serving_requests"]["samples"])
    assert not os.path.exists(os.path.join(cdir, "telemetry",
                                           "host0.addr"))


def test_merge_expositions_groups_families():
    a = ("# HELP m total\n# TYPE m counter\nm 1.0\n"
         "# TYPE h histogram\nh_bucket{le=\"+Inf\"} 1\nh_sum 0.5\n"
         "h_count 1\n")
    b = "# TYPE m counter\nm{x=\"y\"} 2.0\n"
    merged = merge_expositions({0: a, 1: b, 2: None})
    assert merged == REF.live.merge_expositions({0: a, 1: b, 2: None})
    fams = parse_exposition(merged)
    assert ("m", {"host": "0"}, "1.0") in fams["m"]["samples"]
    assert ("m", {"host": "1", "x": "y"}, "2.0") in fams["m"]["samples"]
    assert ("h_bucket", {"host": "0", "le": "+Inf"}, "1") in \
        fams["h"]["samples"]


# -------------------------------------- the acceptance integration


def test_live_plane_end_to_end_engine_healthz_slo_waterfall(tmp_path):
    """``obs.session(serve_port=0)`` over a real port ContinuousBatcher
    workload: /metrics parses with serving_* series, /healthz flips when
    the heartbeat goes stale, an injected latency spike trips the rule,
    and the waterfall renders the queued request's stages."""
    from distkeras_tpu_torch.serving import ContinuousBatcher

    m = model()
    path = str(tmp_path / "serve.jsonl")
    hb = str(tmp_path / "hb")
    clk, hclk = [0.0], [1000.0]
    rng = np.random.default_rng(0)
    health = HeartbeatHealth(hb, host=0, window=2.0, clock=lambda: hclk[0])
    rules = [SloRule("serving.request_s", percentile=0.95, threshold=1.0,
                     window_s=30.0)]
    hits = []
    with obs.session(trace_path=path, serve_port=0, health=health,
                     slo_rules=rules, slo_tick_s=30.0) as sess:
        sess.slo.subscribe(lambda rule, v: hits.append((rule.metric, v)))
        url = sess.server.url
        eng = ContinuousBatcher(m["p"], m["cfg"], lanes=2, max_queue=4,
                                prompt_buckets=(8,), prefill_chunk=8,
                                clock=lambda: clk[0], device="cpu")
        prompts = [rng.integers(0, 64, (n,)).astype(np.int32)
                   for n in (20, 4, 4)]
        rids = [eng.enqueue(p, 5) for p in prompts]
        assert eng.queued == 1
        while any(eng.poll(r) is None for r in rids):
            clk[0] += 2.0
            eng.step()
        res = [eng.take(r) for r in rids]
        assert all(r.ok for r in res)
        for r, p in zip(res, prompts):
            np.testing.assert_array_equal(r.tokens, m["jsolo"](p, 5))
        write_beat(hb, 0, epoch=0, n=1, clock=lambda: hclk[0])
        fams = parse_exposition(get(url + "/metrics"))
        assert fams["serving_requests"]["type"] == "counter"
        assert fams["serving_request_s"]["type"] == "histogram"
        assert "serving_ttft_s" in fams and "serving_tpot_s" in fams
        assert json.loads(get(url + "/healthz"))["ok"]
        hclk[0] += 30.0
        with pytest.raises(urllib.error.HTTPError) as ei:
            get(url + "/healthz")
        assert ei.value.code == 503
        sess.slo.tick()
        assert hits and hits[0][0] == "serving.request_s"
        fams = parse_exposition(get(url + "/metrics"))
        assert "slo_windowed" in fams and "slo_breaches" in fams
    recs = read_trace(path)
    assert any(r.get("kind") == "event" and r["name"] == "slo.breach"
               for r in recs)
    wf = request_waterfall(recs, rids[2])
    assert wf == REF.report.request_waterfall(recs, rids[2])
    assert wf["found"] and wf["status"] == "ok"
    assert wf["queue_wait_s"] is not None and wf["queue_wait_s"] >= 0
    assert wf["ttft_s"] > 0 and wf["tokens"] == 5
    assert wf["gaps"] and wf["gaps"]["count"] >= 1
    text = render_waterfall(wf)
    assert text == REF.report.render_waterfall(wf)
    assert "serving.emit" in text and "serving.finish" in text
    wf_long = request_waterfall(recs, rids[0])
    assert wf_long["prefill_chunks"] >= 1 and wf_long["prompt_len"] == 20


def test_request_waterfall_speculative_and_unknown_id(tmp_path):
    import dataclasses

    from distkeras_tpu_torch.models.transformer import (TransformerConfig,
                                                        init_params)
    from distkeras_tpu_torch.serving import SpeculativeBatcher

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                            n_layers=2, d_ff=64, max_len=32)
    draft = dataclasses.replace(cfg, d_model=16, n_layers=1, d_ff=32)
    path = str(tmp_path / "spec.jsonl")
    with obs.session(trace_path=path):
        eng = SpeculativeBatcher(init_params(0, cfg, device="cpu"),
                                 init_params(1, draft, device="cpu"),
                                 cfg, draft, lanes=2, n_draft=2,
                                 max_queue=2, device="cpu")
        rid = eng.enqueue(np.arange(4, dtype=np.int32), 6)
        while eng.poll(rid) is None:
            eng.step()
        assert eng.take(rid).ok
    recs = read_trace(path)
    wf = request_waterfall(recs, rid)
    assert wf["found"] and wf["status"] == "ok" and wf["tokens"] == 6
    names = [s["name"] for s in wf["stages"]]
    assert "serving.admit" in names and "serving.finish" in names
    assert not request_waterfall(recs, 12345)["found"]
