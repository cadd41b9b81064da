"""Live telemetry plane: the in-process HTTP scrape endpoint.

The port's copy of ``distkeras_tpu/obs/live.py``.  The Prometheus text
exposition, registry snapshots, the JSONL event trace — served live
while a trainer or serving engine runs, from a stdlib
``ThreadingHTTPServer`` on a daemon thread:

=====================  ==================================================
endpoint               serves
=====================  ==================================================
``/metrics``           the registry's Prometheus text exposition
``/snapshot.json``     ``MetricsRegistry.snapshot()`` as JSON
``/healthz``           heartbeat freshness (resilience/health.py):
                       200 fresh / 503 stale — the health-check a
                       router or k8s probe points at
``/trace/tail?n=N``    the last N JSONL trace records (torn-tail
                       tolerant, like ``read_trace``)
``/metrics/cluster``   every cluster host's ``/metrics`` merged, each
                       series labeled ``host="N"`` (federation)
``/residency``         the attached engine's residency digest
                       (resident stem hashes / prefix ids / live
                       load — ``residency=engine.residency``): the
                       cache-aware router's affinity ground truth
                      
=====================  ==================================================

Started via ``obs.session(serve_port=...)`` (port 0 = ephemeral; the
bound port is ``sess.server.port``).  **Cluster federation**: when the
``DKT_CLUSTER_*`` env contract is present (the ``ClusterSupervisor``
driver sets it; resilience/cluster.py), every host's server publishes
its address as ``<DKT_CLUSTER_DIR>/telemetry/host<N>.addr`` and
``/metrics/cluster`` scrapes every published peer, so host 0's
endpoint is the one place a fleet dashboard scrapes — a killed host's
series drop out (its scrape fails, ``cluster_scrape_up{host} 0``) and
return when the coordinated restart republishes its address.

Request handlers only read the registry and the trace file; no handler
touches a device.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from distkeras_tpu_torch.utils.locks import assert_unlocked


# ------------------------------------------------------------- health


class HeartbeatHealth:
    """``/healthz`` source wired to resilience/health.py beat files:
    healthy while THIS host's latest beat is younger than ``window``
    seconds (or is the terminal ``done`` beat — clean completion is
    not sickness).  A wedged heartbeat writer (the ``stall`` chaos
    kind) therefore flips the endpoint 200 -> 503 within one window,
    with no cooperation from the wedged thread."""

    def __init__(self, directory: str, host: int, window: float = 3.0,
                 clock=time.time):
        if window <= 0:
            raise ValueError(f"window must be > 0, got {window}")
        self.directory = directory
        self.host = host
        self.window = window
        self._clock = clock

    def __call__(self):
        # Late import: health.py is stdlib-only, but routing through
        # the resilience package keeps this module importable under
        # obs_report.py's no-framework stub loader.
        from distkeras_tpu_torch.resilience.health import beat_age

        aged = beat_age(self.directory, self.host, clock=self._clock)
        if aged is None:
            return False, {"source": "heartbeat", "host": self.host,
                           "error": "no beat file"}
        age, done = aged
        ok = done or age <= self.window
        return ok, {"source": "heartbeat", "host": self.host,
                    "age_s": round(age, 3), "window_s": self.window,
                    "done": done}


def _health_from_env():
    env = os.environ
    if "DKT_CLUSTER_DIR" in env:
        return HeartbeatHealth(
            os.path.join(env["DKT_CLUSTER_DIR"], "hb"),
            host=int(env.get("DKT_CLUSTER_HOST", "0")),
            window=float(env.get("DKT_CLUSTER_WINDOW", "3.0")))
    return lambda: (True, {"source": "none"})


# --------------------------------------------------------- federation


def merge_expositions(texts: dict) -> str:
    """Merge per-host Prometheus text expositions into ONE, each
    sample labeled ``host="N"``.  ``texts``: ``{host_id: exposition
    text | None}`` (None = unreachable).  Metric families stay grouped
    (one HELP/TYPE header, then every host's samples) — the text
    format requires all lines of a family in one block.  Reachability
    itself is a series: ``cluster_scrape_up{host="N"} 0|1``."""
    helps: dict[str, str] = {}
    types: dict[str, str] = {}
    samples: dict[str, list[str]] = {}
    order: list[str] = []

    def family_of(name: str) -> str:
        if name in types:
            return name
        for suf in ("_bucket", "_sum", "_count", "_total"):
            if name.endswith(suf) and name[:-len(suf)] in types:
                return name[:-len(suf)]
        return name

    def add(family: str, line: str) -> None:
        if family not in samples:
            samples[family] = []
            order.append(family)
        samples[family].append(line)

    for host in sorted(texts):
        text = texts[host]
        if text is None:
            continue
        for line in text.splitlines():
            line = line.rstrip()
            if not line:
                continue
            if line.startswith("# HELP "):
                _, _, rest = line.partition("# HELP ")
                name = rest.split(" ", 1)[0]
                helps.setdefault(name, line)
                continue
            if line.startswith("# TYPE "):
                _, _, rest = line.partition("# TYPE ")
                name = rest.split(" ", 1)[0]
                types.setdefault(name, rest.split(" ", 2)[1]
                                 if len(rest.split(" ")) > 1 else "")
                continue
            if line.startswith("#"):
                continue
            brace = line.find("{")
            space = line.find(" ")
            if brace != -1 and (space == -1 or brace < space):
                name = line[:brace]
                rest = line[brace + 1:]
                new = f'{name}{{host="{host}",{rest}'
            else:
                name, _, value = line.partition(" ")
                new = f'{name}{{host="{host}"}} {value}'
            add(family_of(name), new)

    up = "cluster_scrape_up"
    lines = [f"# HELP {up} 1 when the host's /metrics scrape "
             "succeeded, 0 when it was unreachable",
             f"# TYPE {up} gauge"]
    for host in sorted(texts):
        ok = 0 if texts[host] is None else 1
        lines.append(f'{up}{{host="{host}"}} {ok}')
    for family in order:
        if family in helps:
            lines.append(helps[family])
        if family in types:
            lines.append(f"# TYPE {family} {types[family]}")
        lines.extend(samples[family])
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------- server


class _Handler(BaseHTTPRequestHandler):
    # The telemetry wire protocol: routes, params and status codes are
    # the reference's, as scripts/obs_schema.json lists them.
    server_version = "dkt-telemetry/1.0"

    def log_message(self, *a):  # pragma: no cover — silence stderr
        pass

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 — http.server API
        tel: "TelemetryServer" = self.server.telemetry
        url = urlparse(self.path)
        try:
            if url.path == "/metrics":
                self._send(200, tel.registry.render_text(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif url.path == "/snapshot.json":
                self._send(200, json.dumps(tel.registry.snapshot(),
                                           default=str),
                           "application/json")
            elif url.path == "/healthz":
                ok, detail = tel.check_health()
                self._send(200 if ok else 503,
                           json.dumps({"ok": ok, **detail}),
                           "application/json")
            elif url.path == "/trace/tail":
                q = parse_qs(url.query)
                n = int(q.get("n", ["50"])[0])
                body = tel.trace_tail(n)
                if body is None:
                    self._send(404, "no trace attached to this "
                               "session\n", "text/plain")
                else:
                    self._send(200, body, "application/x-ndjson")
            elif url.path == "/metrics/cluster":
                self._send(200, tel.cluster_metrics(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif url.path == "/residency":
                doc = tel.residency_doc()
                if doc is None:
                    self._send(404, "no residency source attached "
                               "to this server (pass residency= a "
                               "callable, e.g. engine.residency)\n",
                               "text/plain")
                else:
                    self._send(200, json.dumps(doc, default=str),
                               "application/json")
            else:
                self._send(404, f"unknown endpoint {url.path}\n"
                           "(try /metrics /snapshot.json /healthz "
                           "/trace/tail /metrics/cluster "
                           "/residency)\n",
                           "text/plain")
        except BrokenPipeError:  # pragma: no cover — client went away
            pass
        except Exception as e:  # noqa: BLE001 — a torn scrape must
            try:                 # not kill the serving thread
                self._send(500, f"{type(e).__name__}: {e}\n",
                           "text/plain")
            except Exception:  # pragma: no cover
                pass


class TelemetryServer:
    """The live scrape endpoint (see module docstring).

    ``registry`` is the live metrics registry; ``trace_path`` enables
    ``/trace/tail`` (which first writes out the active ``obs`` session's
    buffered records when that session writes ``trace_path``);
    ``health`` is a callable ``() -> (ok, detail)`` (or ``(ok,)``/bool),
    default: heartbeat freshness from the ``DKT_CLUSTER_*`` env when
    present, else always-healthy.
    ``cluster_dir``/``host_id`` opt into federation explicitly (tests;
    production rides the env contract).  ``port=0`` binds an ephemeral
    port — read ``server.port`` / ``server.url`` after :meth:`start`.

    ``advertise``: the hostname/IP peers should dial for federation —
    what the published ``.addr`` file carries, NOT necessarily the
    bind address.  Defaults to ``$DKT_TELEMETRY_ADVERTISE``, else the
    machine hostname when binding a wildcard address, else the bind
    address itself (correct for the single-machine harness; a real
    multi-machine fleet binds ``0.0.0.0`` or sets the env var —
    advertising a loopback bind to remote peers would make every peer
    dial itself).
    """

    def __init__(self, registry, *, port: int = 0,
                 bind: str = "127.0.0.1", trace_path: str | None = None,
                 health=None, cluster_dir: str | None = None,
                 host_id: int | None = None, advertise: str | None = None,
                 scrape_timeout: float = 1.0, residency=None):
        self.registry = registry
        self.trace_path = trace_path
        # ``/residency`` source: a callable returning the
        # engine's residency digest dict (``engine.residency`` — the
        # cache-aware router's affinity ground truth).  The server only
        # relays the dict.
        self._residency = residency
        self._health = health if health is not None \
            else _health_from_env()
        env = os.environ
        if cluster_dir is None and "DKT_CLUSTER_DIR" in env:
            cluster_dir = env["DKT_CLUSTER_DIR"]
        if host_id is None:
            host_id = int(env.get("DKT_CLUSTER_HOST", "0"))
        self.cluster_dir = cluster_dir
        self.host_id = host_id
        self.scrape_timeout = scrape_timeout
        self._bind = bind
        if advertise is None:
            advertise = env.get("DKT_TELEMETRY_ADVERTISE")
        if advertise is None and bind in ("", "0.0.0.0", "::"):
            import socket

            advertise = socket.gethostname()
        self.advertise = advertise if advertise is not None else bind
        self._want_port = port
        self._httpd = None
        self._thread = None
        self.port = None

    # --------------------------------------------------------- lifecycle

    @property
    def url(self) -> str:
        return f"http://{self._bind}:{self.port}"

    def start(self) -> "TelemetryServer":
        if self._httpd is not None:
            raise RuntimeError("telemetry server already started")
        self._httpd = ThreadingHTTPServer((self._bind, self._want_port),
                                          _Handler)
        self._httpd.daemon_threads = True
        self._httpd.telemetry = self
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="dkt-telemetry", daemon=True)
        self._thread.start()
        self._publish_addr()
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._unpublish_addr()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ----------------------------------------------------------- health

    def check_health(self):
        # The injected probe is user code: it must never run under a
        # sanitized lock (it may block on I/O or call back into obs).
        assert_unlocked("obs.live health probe")
        try:
            out = self._health()
        except Exception as e:  # noqa: BLE001 — a broken probe is down
            return False, {"error": f"{type(e).__name__}: {e}"}
        if isinstance(out, tuple):
            ok, detail = out
            return bool(ok), dict(detail)
        return bool(out), {}

    # ------------------------------------------------------- residency

    def residency_doc(self):
        """The attached residency source's digest, or None when no
        source is attached.  Never runs under a sanitized lock (the
        source is engine code that takes the admission lock
        itself)."""
        if self._residency is None:
            return None
        assert_unlocked("obs.live residency source")
        return self._residency()

    # ------------------------------------------------------- trace tail

    def trace_tail(self, n: int) -> str | None:
        """The last ``n`` records of the session's trace file as
        NDJSON (the same torn-tail tolerance as ``read_trace``: a
        half-written final line from the live writer is dropped, not
        an error)."""
        if self.trace_path is None:
            return None
        from distkeras_tpu_torch import obs
        from distkeras_tpu_torch.obs.trace import tail_trace

        sess = obs.active()
        if (sess is not None and sess.trace is not None
                and sess.trace.path == os.path.abspath(self.trace_path)):
            sess.trace.flush()
        recs = tail_trace(self.trace_path, max(n, 0))
        return "".join(json.dumps(r, default=str) + "\n" for r in recs)

    # ------------------------------------------------------- federation

    def _addr_dir(self) -> str | None:
        if self.cluster_dir is None:
            return None
        return os.path.join(self.cluster_dir, "telemetry")

    def _publish_addr(self) -> None:
        d = self._addr_dir()
        if d is None:
            return
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".addr.{self.host_id}.{os.getpid()}.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"host": self.host_id,
                       "addr": f"{self.advertise}:{self.port}",
                       "pid": os.getpid()}, f)
        os.replace(tmp, os.path.join(d, f"host{self.host_id}.addr"))

    def _unpublish_addr(self) -> None:
        d = self._addr_dir()
        if d is None:
            return
        try:
            os.remove(os.path.join(d, f"host{self.host_id}.addr"))
        except OSError:
            pass

    def peers(self) -> dict:
        """``{host_id: "ip:port"}`` for every published telemetry
        address in the cluster dir (self included)."""
        d = self._addr_dir()
        out = {}
        if d is None or not os.path.isdir(d):
            return out
        for name in sorted(os.listdir(d)):
            if not (name.startswith("host") and name.endswith(".addr")):
                continue
            try:
                with open(os.path.join(d, name), encoding="utf-8") as f:
                    rec = json.load(f)
                out[int(rec["host"])] = rec["addr"]
            except (OSError, ValueError, KeyError):
                continue  # torn publish mid-replace: skip this pass
        return out

    def _scrape_peer(self, addr: str) -> str | None:
        try:
            with urllib.request.urlopen(
                    f"http://{addr}/metrics",
                    timeout=self.scrape_timeout) as resp:
                return resp.read().decode("utf-8")
        except Exception:  # noqa: BLE001 — dead peer == absent
            return None

    def cluster_metrics(self) -> str:
        """The federated exposition: every published host's
        ``/metrics`` merged with ``host=`` labels (own registry read
        locally — no self-scrape loop).  Peers are scraped
        CONCURRENTLY, so N dead peers cost one ``scrape_timeout``
        total, not N — unreachable ones are skipped and reported via
        ``cluster_scrape_up``."""
        import concurrent.futures

        peers = self.peers()
        if not peers:
            peers = {self.host_id: f"{self.advertise}:{self.port}"}
        texts: dict = {}
        remote = {h: a for h, a in peers.items() if h != self.host_id}
        if self.host_id in peers or not remote:
            texts[self.host_id] = self.registry.render_text()
        if remote:
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=min(len(remote), 16),
                    thread_name_prefix="dkt-fed-scrape") as pool:
                futs = {h: pool.submit(self._scrape_peer, a)
                        for h, a in remote.items()}
                for h, fut in futs.items():
                    texts[h] = fut.result()
        return merge_expositions(texts)


__all__ = ["TelemetryServer", "HeartbeatHealth", "merge_expositions"]
