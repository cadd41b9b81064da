"""Shared pieces of the port's fleet parity tests (router, disagg,
autoscale, weight push, the contract tests).

``PORT`` and ``REF`` name the same fleet surface in the two packages,
so one scenario runs against each and the tests compare what they
observe.  :class:`FakeReplica` is the reference tests' scripted replica
(no model work), raising the exceptions of the package it is built for.
:func:`model` builds the small config once: the JAX params as numpy,
the port's copy on the CPU, and memoized lone-engine oracles of both
packages.
"""

import types
import warnings

import numpy as np

import distkeras_tpu.obs as j_obs
import distkeras_tpu.serving as j_serving
import distkeras_tpu_torch.obs as t_obs
import distkeras_tpu_torch.serving as t_serving
from distkeras_tpu.obs import live as j_live
from distkeras_tpu.obs import metrics as j_metrics
from distkeras_tpu.obs import report as j_report
from distkeras_tpu.obs import slo as j_slo
from distkeras_tpu.resilience import admission as j_adm
from distkeras_tpu.resilience import health as j_health
from distkeras_tpu.serving import residency as j_res
from distkeras_tpu_torch.obs import live as t_live
from distkeras_tpu_torch.obs import metrics as t_metrics
from distkeras_tpu_torch.obs import report as t_report
from distkeras_tpu_torch.obs import slo as t_slo
from distkeras_tpu_torch.resilience import admission as t_adm
from distkeras_tpu_torch.resilience import health as t_health
from distkeras_tpu_torch.serving import residency as t_res

CFG_KW = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              max_len=32, rope=True)
BLOCK = 8


def _ns(obs, serving, adm, health, res, metrics, slo, live, report):
    return types.SimpleNamespace(
        obs=obs, serving=serving, Router=serving.Router,
        InProcessReplica=serving.InProcessReplica,
        HttpReplica=serving.HttpReplica,
        EngineEndpoint=serving.EngineEndpoint,
        QueueFull=adm.QueueFull, EngineClosed=adm.EngineClosed,
        RequestResult=adm.RequestResult, write_beat=health.write_beat,
        beat_age=health.beat_age, stem_hexes=res.stem_hexes,
        MetricsRegistry=metrics.MetricsRegistry, SloEngine=slo.SloEngine,
        SloRule=slo.SloRule, live=live, report=report)


PORT = _ns(t_obs, t_serving, t_adm, t_health, t_res, t_metrics, t_slo,
           t_live, t_report)
REF = _ns(j_obs, j_serving, j_adm, j_health, j_res, j_metrics, j_slo,
          j_live, j_report)
BOTH = (PORT, REF)


def both(scenario, *args, **kw):
    """Run ``scenario(ns, ...)`` against the port and the reference and
    return the port's outcome once the two agree."""
    got = scenario(PORT, *args, **kw)
    want = scenario(REF, *args, **kw)
    assert got == want, (got, want)
    return got


class FakeReplica:
    """A replica that admits into a bounded table and finishes requests
    only when the test says so: routing decisions become deterministic
    and need no model (the reference tests' fake)."""

    remote = False

    def __init__(self, ns, name, lanes=2, max_queue=2, block=BLOCK,
                 resident=(), prefix_ids=(), healthy=True):
        self.ns = ns
        self.name = name
        self.lanes = lanes
        self.max_queue = max_queue
        self.block = block
        self.resident = list(resident)
        self.prefix_ids = list(prefix_ids)
        self.is_healthy = healthy
        self.closed = False
        self._next = 0
        self.live = {}
        self.done = {}
        self.enqueued = []
        self.steps = 0
        self.version = 0

    def set_rid_base(self, base):
        self._next = max(self._next, base)

    def enqueue(self, prompt, max_new_tokens, **kw):
        if self.closed:
            raise self.ns.EngineClosed("fake closed")
        if len(self.live) >= self.lanes + self.max_queue:
            raise self.ns.QueueFull("fake full")
        rid = self._next
        self._next += 1
        self.live[rid] = (np.asarray(prompt, np.int32), int(max_new_tokens))
        self.enqueued.append(rid)
        return rid

    def complete_all(self, status="ok"):
        for rid, (prompt, n) in list(self.live.items()):
            tokens = np.concatenate([prompt, np.zeros(n, np.int32)])
            self.done[rid] = self.ns.RequestResult(
                request_id=rid, tokens=tokens, status=status,
                prompt_len=prompt.size)
            del self.live[rid]

    def poll(self, rid):
        return self.done.get(rid)

    def partial(self, rid):
        return self.done.get(rid)

    def step(self):
        self.steps += 1

    def healthy(self):
        return self.is_healthy

    def residency(self):
        return {"stem_hashes": self.resident,
                "prefix_ids": self.prefix_ids, "block": self.block,
                "queue_depth": max(0, len(self.live) - self.lanes),
                "lanes_busy": min(len(self.live), self.lanes),
                "lanes": self.lanes, "param_version": self.version}

    def load(self):
        return (max(0, len(self.live) - self.lanes),
                min(len(self.live), self.lanes), self.lanes)

    def param_version(self):
        return self.version


class HealthProbed:
    """A FakeReplica with an injected health probe (the
    ``InProcessReplica(health=)`` shape, without an engine)."""

    remote = False

    def __init__(self, fake, health):
        self._fake = fake
        self._health = health
        self.name = fake.name

    def healthy(self):
        return bool(self._health())

    def __getattr__(self, item):
        return getattr(self._fake, item)


def prompt_of(rng, n=20):
    return rng.integers(0, 64, (n,)).astype(np.int32)


def model():
    """The small config in both packages: JAX params (numpy), the port's
    CPU copy, and memoized lone-engine oracles — ``jsolo`` (a JAX
    ``ContinuousBatcher`` serving each prompt alone, whose tokens are the
    JAX ``generate``'s by the JAX package's own tests) and ``tsolo`` (the
    port's ``generate``)."""
    import jax

    from distkeras_tpu.models import transformer as jtfm
    from distkeras_tpu_torch.models import generate as tgen
    from distkeras_tpu_torch.models import transformer as ttfm
    from distkeras_tpu_torch.utils.serialization import params_from_numpy

    jcfg = jtfm.TransformerConfig(**CFG_KW)
    jp = jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(0), jcfg))
    cfg = ttfm.TransformerConfig(**CFG_KW)
    p = params_from_numpy(jp, "cpu")
    engines, memo = {}, {}

    def jsolo(prompt, n, kv_int8=False):
        key = (tuple(int(t) for t in prompt), n, kv_int8)
        if key not in memo:
            if kv_int8 not in engines:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    engines[kv_int8] = j_serving.ContinuousBatcher(
                        jp, jcfg, lanes=1, prompt_buckets=(8, 32),
                        kv_int8=kv_int8)
            eng = engines[kv_int8]
            lane = eng.submit(np.asarray(prompt, np.int32), n)
            while lane in eng.running():
                eng.step()
            memo[key] = np.asarray(eng.drain(lane))
        return memo[key]

    def tsolo(prompt, n, **kw):
        return tgen.generate(p, np.asarray(prompt)[None], cfg, n,
                             device="cpu", **kw)[0].numpy()

    return dict(jcfg=jcfg, jp=jp, cfg=cfg, p=p, jsolo=jsolo, tsolo=tsolo)


def paged(m, **kw):
    """The reference tests' small paged engine, on the port."""
    kw.setdefault("prompt_buckets", (8,))
    kw.setdefault("max_queue", 8)
    kw.setdefault("n_blocks", 2 * (CFG_KW["max_len"] // BLOCK) + 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # kv_int8 advisory
        return t_serving.PagedBatcher(m["p"], m["cfg"], lanes=2,
                                      block=BLOCK, device="cpu", **kw)


def jpaged(m, **kw):
    """The same engine on the JAX package."""
    kw.setdefault("prompt_buckets", (8,))
    kw.setdefault("max_queue", 8)
    kw.setdefault("n_blocks", 2 * (CFG_KW["max_len"] // BLOCK) + 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return j_serving.PagedBatcher(m["jp"], m["jcfg"], lanes=2,
                                      block=BLOCK, **kw)


def count(sess, name):
    doc = sess.registry.snapshot().get(name)
    if not doc:
        return 0.0
    return sum(s["value"] for s in doc["series"])


def run(router, rids, steps=10_000):
    for _ in range(steps):
        if all(router.poll(r) is not None for r in rids):
            return [router.take(r) for r in rids]
        router.step()
    raise AssertionError("router did not finish the requests")
