"""The port's PagedBatcher against the JAX package (CPU, f32).

Mirrors ``tests/test_serving_paged.py``: every request's emitted tokens
equal (no tolerance) the JAX package's for the same prompt and the
port's own ``ContinuousBatcher``'s, and the block slab, the page-table
gather, stem sharing and copy-on-write forks are invisible in them.  The
JAX oracle is a module-scoped JAX ``ContinuousBatcher`` serving each
prompt alone (its tokens are the JAX ``generate``'s by the JAX package's
own tests), and a JAX ``PagedBatcher`` runs the staggered, stem-sharing
and fork schedules beside the port's with the same block ids.  Sampled
lanes cannot match JAX's PRNG, so each is held to the port's own solo
``generate(seed=)`` (the ``key=`` of the reference is the port's
``seed=``).  The allocator is held to JAX's ``BlockAllocator`` on one
scripted trace, and the stem hashes to the reference's bytes.

The reference's ``test_paged_zero_steady_state_compiles`` has no CPU
counterpart (eager torch compiles nothing): its counterpart is the card's
allocator stability, phase ``paged`` (f) of ``chip_smoke.py`` and
``tests/test_torch_cuda.py::test_paged_serve_phase_allocates_nothing``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import generate as jgen
from distkeras_tpu.models import transformer as jtfm
from distkeras_tpu.serving import ContinuousBatcher as JaxBatcher
from distkeras_tpu.serving import PagedBatcher as JaxPaged
from distkeras_tpu.serving.paged import BlockAllocator as JaxAllocator
from distkeras_tpu.serving.residency import stem_hashes as j_stem_hashes
from distkeras_tpu_torch import obs
from distkeras_tpu_torch.models import generate as tgen
from distkeras_tpu_torch.models import transformer as ttfm
from distkeras_tpu_torch.models.quant import quantize_params
from distkeras_tpu_torch.serving import (BlockAllocator, ContinuousBatcher,
                                         PagedBatcher, QueueFull, chain_hash,
                                         stem_hashes, stem_hexes)
from distkeras_tpu_torch.serving.paged import (KV_INT8_PREFILL_LOGIT_TOL,
                                               TRASH_BLOCK)
from distkeras_tpu_torch.utils.serialization import params_from_numpy

# The kv_int8 engines here run at few lanes by design; the
# construction advisory they earn is tested in
# tests/test_torch_fleet_contract.py.
pytestmark = pytest.mark.filterwarnings(
    "ignore:kv_int8=True with:RuntimeWarning")

KW = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
          max_len=32, rope=True)

BLOCK = 8
MB = KW["max_len"] // BLOCK


@pytest.fixture(scope="module")
def m():
    jcfg = jtfm.TransformerConfig(**KW)
    jp = jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(0), jcfg))
    engines, memo = {}, {}

    def jsolo(prompt, n, kv_int8=False):
        """The JAX package's tokens for ``prompt`` alone (a JAX lane
        engine, built once per kv_int8 mode), memoized."""
        key = (tuple(int(t) for t in prompt), n, kv_int8)
        if key not in memo:
            if kv_int8 not in engines:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    engines[kv_int8] = JaxBatcher(
                        jp, jcfg, lanes=1, prompt_buckets=(8,),
                        kv_int8=kv_int8)
            eng = engines[kv_int8]
            lane = eng.submit(np.asarray(prompt, np.int32), n)
            while lane in eng.running():
                eng.step()
            memo[key] = eng.drain(lane)
        return memo[key]

    return dict(jcfg=jcfg, jp=jp, cfg=ttfm.TransformerConfig(**KW),
                p=params_from_numpy(jp, "cpu"), jsolo=jsolo)


def paged(m, lanes=2, n_blocks=None, **kw):
    kw.setdefault("prompt_buckets", (8,))
    if n_blocks is None:
        n_blocks = lanes * MB + 1
    return PagedBatcher(m["p"], m["cfg"], lanes=lanes, block=BLOCK,
                        n_blocks=n_blocks, device="cpu", **kw)


def jpaged(m, lanes=2, n_blocks=None, **kw):
    kw.setdefault("prompt_buckets", (8,))
    if n_blocks is None:
        n_blocks = lanes * MB + 1
    return JaxPaged(m["jp"], m["jcfg"], lanes=lanes, block=BLOCK,
                    n_blocks=n_blocks, **kw)


def run_to_done(eng, lane):
    while lane in eng.running():
        eng.step()
    return np.asarray(eng.drain(lane))


def tsolo(m, prompt, n, **kw):
    return tgen.generate(m["p"], np.asarray(prompt)[None], m["cfg"], n,
                         device="cpu", **kw)[0].numpy()


def ints(rng, n):
    return rng.integers(0, 64, (n,)).astype(np.int32)


def assert_no_leak(eng):
    """Every block is back on the free list and no lane table points
    anywhere but trash."""
    st = eng.allocator.stats()
    assert st["used"] == 0 and st["free"] == st["capacity"], st
    assert (eng._tables_np == TRASH_BLOCK).all()
    assert all(not b for b in eng._lane_blocks)


# ---------------------------------------------------- allocator unit


def _allocator_trace(a):
    """One scripted op trace; returns everything it observed."""
    seen = []
    b1, b2 = a.alloc(), a.alloc()
    a.share(b1)
    a.register(b1, b"h1")
    seen += [b1, b2, a.refs_of(b1), a.share_by_hash(b"h1"), a.stats()]
    for _ in range(3):
        a.free(b1)
    seen += [a.refs_of(b1), a.stats(), a.share_by_hash(b"h1")]
    a.register(b2, b"h2")
    a.free(b1)
    seen += [sorted(a.resident_hashes()), a.stats()]
    got = [a.alloc() for _ in range(4)]
    seen += [got, a.alloc(), a.share_by_hash(b"h1"), a.share_by_hash(b"h2"),
             a.stats(), sorted(a.resident_hashes())]
    for bid in got[:2]:
        a.free(bid)
    a.register(got[2], b"h3")
    seen += [a.alloc(), a.stats(), sorted(a.resident_hashes()),
             [a.refs_of(b) for b in range(5)]]
    return seen


def test_allocator_trace_equals_reference():
    """The same op trace gives the same block ids, refcounts, stats and
    resident hashes as the JAX package's allocator."""
    assert (_allocator_trace(BlockAllocator(n_blocks=5, block=8))
            == _allocator_trace(JaxAllocator(n_blocks=5, block=8)))


def test_allocator_refcount_and_residency():
    a = BlockAllocator(n_blocks=5, block=8)   # blocks 1..4 usable
    assert a.capacity == 4
    b1, b2 = a.alloc(), a.alloc()
    assert a.refs_of(b1) == 1
    a.share(b1)
    assert a.refs_of(b1) == 2
    a.register(b1, b"h1")
    assert a.share_by_hash(b"h1") == b1
    assert a.refs_of(b1) == 3
    # Freed to zero: on the free list but hash-resident (revivable)...
    for _ in range(3):
        a.free(b1)
    assert a.refs_of(b1) == 0
    assert a.stats()["free"] == 3
    assert a.share_by_hash(b"h1") == b1        # revived
    a.free(b1)
    # ...until the free list recycles it: alloc purges the hash.
    got = {a.alloc() for _ in range(4)}
    assert len(got) == 4
    assert a.alloc() is None                   # exhausted, no raise
    assert a.share_by_hash(b"h1") is None      # recycled -> purged
    with pytest.raises(ValueError, match="not live"):
        a.free(99)
    a.free(b2)
    with pytest.raises(ValueError, match="not live"):
        a.free(b2)                             # double free
    with pytest.raises(ValueError, match="not live"):
        a.share(b2)
    with pytest.raises(ValueError, match="n_blocks"):
        BlockAllocator(n_blocks=1, block=8)


def test_allocator_register_first_writer_wins():
    a = BlockAllocator(n_blocks=4, block=8)
    b1, b2 = a.alloc(), a.alloc()
    a.register(b1, b"h")
    a.register(b2, b"h")                       # identical content
    assert a.share_by_hash(b"h") == b1
    a.free(b1)
    a.free(b1)
    a.free(b2)
    assert a.stats()["used"] == 0


def test_stem_hashes_are_the_reference_bytes(m, rng):
    """chain_hash / stem_hashes / stem_hexes give the reference's bytes
    (a router on another host compares them), and the engine's residency
    digest lists exactly the warm prompt's full-block hashes."""
    from distkeras_tpu.serving.residency import chain_hash as j_chain

    toks = rng.integers(0, 64, (29,))
    for block in (1, 4, 8, 29, 30):
        assert stem_hashes(toks, block) == j_stem_hashes(toks, block)
    assert stem_hexes(toks, 8) == [h.hex() for h in j_stem_hashes(toks, 8)]
    assert chain_hash(b"x", toks[:8]) == j_chain(b"x", toks[:8])
    with pytest.raises(ValueError, match="block"):
        stem_hashes(toks, 0)
    pb = paged(m, lanes=1)
    prompt = ints(rng, 20)
    run_to_done(pb, pb.submit(prompt, 4))
    res = pb.residency()
    assert res["block"] == BLOCK and res["engine"] == "PagedBatcher"
    assert sorted(res["stem_hashes"]) == sorted(stem_hexes(prompt[:-1],
                                                           BLOCK))
    assert res["kv_blocks_free"] == pb.allocator.capacity


# ------------------------------------------------------- parity


def test_paged_greedy_parity_staggered_and_lane_reuse(m, rng):
    """Staggered admission and lane reuse: the port's paged tokens equal
    its ContinuousBatcher's, the JAX paged engine's (with the same block
    ids at each admission) and JAX's solo tokens; no block leaks."""
    pb, cb, jb = paged(m), ContinuousBatcher(
        m["p"], m["cfg"], lanes=2, prompt_buckets=(8,), device="cpu"), \
        jpaged(m)
    prompts = [ints(rng, n) for n in (5, 12, 7)]
    news = (10, 8, 9)
    outs = {}
    lanes1 = [e.submit(prompts[0], 10) for e in (pb, cb, jb)]
    for e in (pb, cb, jb):
        e.step()
    lanes2 = [e.submit(prompts[1], 8) for e in (pb, cb, jb)]
    assert pb._lane_blocks == jb._lane_blocks
    outs[0] = [run_to_done(e, la) for e, la in zip((pb, cb, jb), lanes1)]
    lanes3 = [e.submit(prompts[2], 9) for e in (pb, cb, jb)]
    assert pb._lane_blocks == jb._lane_blocks
    outs[1] = [run_to_done(e, la) for e, la in zip((pb, cb, jb), lanes2)]
    outs[2] = [run_to_done(e, la) for e, la in zip((pb, cb, jb), lanes3)]
    for i, (op, oc, oj) in outs.items():
        np.testing.assert_array_equal(op, oc)
        np.testing.assert_array_equal(op, oj)
        np.testing.assert_array_equal(op, m["jsolo"](prompts[i], news[i]))
    assert_no_leak(pb)
    assert pb.allocator.stats() == jb.allocator.stats()


def test_paged_sampled_parity_per_request(m, rng):
    """Greedy and sampled requests mixed in one paged batch: the sampled
    lane equals the port's solo generate(seed=), the greedy one JAX's."""
    pb = paged(m, per_request_sampling=True, temperature=0.0)
    p1, p2 = ints(rng, 6), ints(rng, 9)
    l1 = pb.submit(p1, 8, seed=11, temperature=0.9, top_p=0.9)
    l2 = pb.submit(p2, 8)                      # greedy default
    o1, o2 = run_to_done(pb, l1), run_to_done(pb, l2)
    np.testing.assert_array_equal(
        o1, tsolo(m, p1, 8, temperature=0.9, top_p=0.9, seed=11))
    np.testing.assert_array_equal(o2, m["jsolo"](p2, 8))
    assert_no_leak(pb)


def test_paged_kv_int8_exact_parity(m, rng):
    """The decode-built int8 slab: the monolithic kv_int8 engine's tokens
    and JAX's kv_int8 lane engine's."""
    pb = paged(m, kv_int8=True)
    cb = ContinuousBatcher(m["p"], m["cfg"], lanes=2, prompt_buckets=(8,),
                           kv_int8=True, device="cpu")
    p = ints(rng, 7)
    out = run_to_done(pb, pb.submit(p, 9))
    np.testing.assert_array_equal(out, run_to_done(cb, cb.submit(p, 9)))
    np.testing.assert_array_equal(out, m["jsolo"](p, 9, kv_int8=True))
    assert pb.cache["k"].dtype == torch.int8 and "k_scale" in pb.cache
    assert_no_leak(pb)


def test_admission_pads_land_in_the_trash_block(m, rng):
    """The bucket pad past the warm frontier is redirected to block 0:
    the lane's own block holds the warm tokens' K/V only."""
    pb = paged(m, lanes=1)
    lane = pb.submit(ints(rng, 5), 3)          # warm 4, bucket 8
    (blk,) = pb._lane_blocks[lane]
    k = pb.cache["k"]
    assert k[:, blk, :4].abs().sum() > 0
    assert k[:, blk, 4:].abs().sum() == 0
    assert k[:, TRASH_BLOCK, 4:].abs().sum() > 0


def test_paged_chunked_prefill_parity(m, rng):
    """Chunked prefill on the slab: the long prompt's chunks land one per
    step while another lane decodes."""
    pb = paged(m, prefill_chunk=8, prompt_buckets=(8, 16))
    ps, pl = ints(rng, 4), ints(rng, 22)
    ls = pb.submit(ps, 12)
    pb.step()
    ll = pb.submit(pl, 6)                      # parks, admits chunked
    assert ll in pb.running()
    assert pb._lane_state[ll].chunks is not None
    np.testing.assert_array_equal(run_to_done(pb, ls), m["jsolo"](ps, 12))
    np.testing.assert_array_equal(run_to_done(pb, ll), m["jsolo"](pl, 6))
    assert_no_leak(pb)


# -------------------------------------------------- stem sharing


def test_stem_sharing_hit_refcounts_and_parity(m, rng):
    """Two requests sharing a 2-block stem: the second refcounts the
    first's blocks (the same block ids as JAX's engine), both match JAX,
    vacating one keeps the shared blocks for the other, and a later
    request revives the freed stem by hash."""
    pb, jb = paged(m, prompt_buckets=(4, 16)), jpaged(m,
                                                      prompt_buckets=(4, 16))
    stem = ints(rng, 16)
    pr1 = np.concatenate([stem, ints(rng, 3)])
    pr2 = np.concatenate([stem, ints(rng, 3)])
    l1, j1 = pb.submit(pr1, 6), jb.submit(pr1, 6)
    used_before = pb.allocator.stats()["used"]
    l2, j2 = pb.submit(pr2, 6), jb.submit(pr2, 6)
    st = pb.allocator.stats()
    assert st["shared"] == 2, st               # both stem blocks hit
    assert st["used"] == used_before + 1, (used_before, st)
    assert pb._lane_blocks[l1][:2] == pb._lane_blocks[l2][:2]
    assert pb._lane_blocks == jb._lane_blocks
    assert pb.stem_hit_blocks == jb.stem_hit_blocks == 2
    o1 = run_to_done(pb, l1)
    st = pb.allocator.stats()
    assert st["shared"] == 0
    assert all(pb.allocator.refs_of(b) == 1 for b in pb._lane_blocks[l2])
    o2 = run_to_done(pb, l2)
    np.testing.assert_array_equal(o1, run_to_done(jb, j1))
    np.testing.assert_array_equal(o2, run_to_done(jb, j2))
    np.testing.assert_array_equal(o1, m["jsolo"](pr1, 6))
    np.testing.assert_array_equal(o2, m["jsolo"](pr2, 6))
    assert_no_leak(pb)
    l3 = pb.submit(pr1, 4)
    assert pb.allocator.stats()["resident_hashes"] >= 2
    assert pb.stem_hit_blocks == 4
    np.testing.assert_array_equal(run_to_done(pb, l3), m["jsolo"](pr1, 4))


def test_stem_sharing_miss_stays_private(m, rng):
    pb = paged(m, prompt_buckets=(4, 16))
    a, b = ints(rng, 18), ints(rng, 18)
    assert not np.array_equal(a[:BLOCK], b[:BLOCK])
    la, lb = pb.submit(a, 5), pb.submit(b, 5)
    assert pb.allocator.stats()["shared"] == 0
    assert not set(pb._lane_blocks[la]) & set(pb._lane_blocks[lb])
    np.testing.assert_array_equal(run_to_done(pb, la), m["jsolo"](a, 5))
    np.testing.assert_array_equal(run_to_done(pb, lb), m["jsolo"](b, 5))


def test_stem_sharing_waits_for_chunked_content(m, rng):
    """A chunk-admitting lane's blocks do not hash-hit before their
    content is dispatched: a same-stem request admitted while the first
    is PARKED shares only the chunk already landed."""
    pb = paged(m, prefill_chunk=8, prompt_buckets=(8, 24))
    stem = ints(rng, 24)
    p1 = np.concatenate([stem, ints(rng, 1)])
    l1 = pb.submit(p1, 4)                      # parked: 3 chunks
    assert pb._lane_state[l1].chunks is not None
    p2 = np.concatenate([stem, ints(rng, 2)])
    l2 = pb.submit(p2, 4)
    assert len(pb._lane_blocks[l2]) >= 3
    assert pb.allocator.stats()["shared"] == 1  # just the landed block
    np.testing.assert_array_equal(run_to_done(pb, l1), m["jsolo"](p1, 4))
    np.testing.assert_array_equal(run_to_done(pb, l2), m["jsolo"](p2, 4))
    assert_no_leak(pb)


def test_stem_hit_unbucketable_span_falls_back(m, rng):
    """A stem hit whose unshared span fits no bucket at the skip offset
    falls back to less sharing (down to a full prefill) and hands the
    surplus references back; a span that fits still shares."""
    pb = paged(m, prompt_buckets=(8,))         # buckets {8, 32}
    stem = ints(rng, 16)
    first = np.concatenate([stem, ints(rng, 2)])
    run_to_done(pb, pb.submit(first, 4))       # makes the stem resident
    prompt = np.concatenate([stem, ints(rng, 10)])  # warm 25
    hits0 = pb.stem_hit_blocks
    lane = pb.submit(prompt, 4)
    assert lane is not None
    assert pb.stem_hit_blocks == hits0
    assert pb.allocator.stats()["shared"] == 0
    np.testing.assert_array_equal(run_to_done(pb, lane),
                                  m["jsolo"](prompt, 4))
    assert_no_leak(pb)
    ok = np.concatenate([stem, ints(rng, 6)])  # warm 21: bucket 8 at 16
    lane = pb.submit(ok, 4)
    assert pb.stem_hit_blocks == hits0 + 2
    np.testing.assert_array_equal(run_to_done(pb, lane), m["jsolo"](ok, 4))
    assert_no_leak(pb)


def test_growth_window_does_not_overallocate_past_budget(m, rng):
    """A window larger than a lane's remaining budget allocates no block
    for the discarded positions (no spurious OOM eviction)."""
    pb = paged(m, n_blocks=3, step_windows=(1, 8))   # 2 usable blocks
    p1, p2 = ints(rng, 8), ints(rng, 8)
    l1, l2 = pb.submit(p1, 1), pb.submit(p2, 1)
    out = pb.step(8)
    assert set(out) == {l1, l2}
    np.testing.assert_array_equal(pb.drain(l1), m["jsolo"](p1, 1))
    np.testing.assert_array_equal(pb.drain(l2), m["jsolo"](p2, 1))
    assert not pb.results()                    # nobody was evicted
    assert_no_leak(pb)


# ----------------------------------------------- pinned prefixes


def test_pinned_prefix_on_slab_parity_and_residency(m, rng):
    """Pin once; a matching prompt hash-hits the pinned blocks (block
    identity), tokens equal JAX's, and unpin releases exactly the pin's
    references."""
    pb = paged(m, prompt_buckets=(4, 16))
    prefix = ints(rng, 17)                     # rounds down to 16
    pid = pb.pin_prefix(prefix)
    assert pb.pinned.length_of(pid) == 16
    pinned_blocks = list(pb.pinned.blocks_of(pid))
    assert pb.allocator.stats()["used"] == 2
    assert pb.residency()["prefix_ids"] == [pid]
    full = np.concatenate([prefix[:16], ints(rng, 4)])
    lane = pb.submit(full, 6)
    assert pb._lane_blocks[lane][:2] == pinned_blocks
    assert all(pb.allocator.refs_of(b) == 2 for b in pinned_blocks)
    np.testing.assert_array_equal(run_to_done(pb, lane),
                                  m["jsolo"](full, 6))
    assert all(pb.allocator.refs_of(b) == 1 for b in pinned_blocks)
    pb.unpin_prefix(pid)
    assert pid not in pb.pinned
    assert_no_leak(pb)
    with pytest.raises(KeyError):
        pb.unpin_prefix(pid)


def test_pinned_prefix_validation(m, rng):
    pb = paged(m, lanes=1)
    with pytest.raises(ValueError, match="full block"):
        pb.pin_prefix(rng.integers(0, 64, (BLOCK - 1,)))
    with pytest.raises(ValueError, match="leave room"):
        pb.pin_prefix(rng.integers(0, 64, (KW["max_len"],)))
    tiny = paged(m, lanes=1, n_blocks=2)
    tiny.pin_prefix(rng.integers(0, 64, (BLOCK,)))
    with pytest.raises(RuntimeError, match="no free KV blocks"):
        tiny.pin_prefix(np.arange(BLOCK, dtype=np.int32))


def test_pin_prefix_rolls_back_on_dispatch_fault(m, rng):
    """A failure after pin_prefix staged its blocks (the admit dispatch)
    hands every staged reference back."""
    pb = paged(m)

    def boom(*a, **kw):
        raise RuntimeError("injected pin fault")
    real, pb._admit = pb._admit, boom
    with pytest.raises(RuntimeError, match="injected pin fault"):
        pb.pin_prefix(ints(rng, 16))
    assert len(pb.pinned) == 0
    assert_no_leak(pb)
    pb._admit = real
    pid = pb.pin_prefix(ints(rng, 16))
    assert pb.allocator.stats()["used"] == 2   # engine still healthy
    pb.unpin_prefix(pid)
    assert_no_leak(pb)


# ------------------------------------------------------ CoW forks


def test_cow_fork_beam_parity(m, rng):
    """Branch on another token mid-decode: the source stays equal to its
    solo run, the branch equals the solo run of its forced transcript
    (JAX's tokens both), only the tail block is fresh, and JAX's engine
    forks to the same block ids."""
    pb, jb = paged(m, lanes=3), jpaged(m, lanes=3)
    p = ints(rng, 6)
    src, jsrc = pb.submit(p, 12), jb.submit(p, 12)
    for _ in range(4):
        pb.step()
        jb.step()
    st = pb._lane_state[src]
    alt = (st.tokens[-1] + 1) % KW["vocab_size"]
    frontier = len(st.tokens) - 1
    f, jf = pb.fork(src, token=alt), jb.fork(jsrc, token=alt)
    assert f is not None and f == jf
    shared = pb._lane_blocks[src][:frontier // BLOCK]
    assert pb._lane_blocks[f][:len(shared)] == shared
    assert len(pb._lane_blocks[f]) == len(shared) + 1  # one copied block
    assert all(pb.allocator.refs_of(b) == 2 for b in shared)
    assert pb._lane_blocks == jb._lane_blocks
    o_src, o_f = run_to_done(pb, src), run_to_done(pb, f)
    np.testing.assert_array_equal(o_src, m["jsolo"](p, 12))
    np.testing.assert_array_equal(o_f, run_to_done(jb, jf))
    forced = np.asarray(o_f[:len(p) + 4])      # prompt + 3 kept + alt
    assert forced[-1] == alt
    np.testing.assert_array_equal(o_f, m["jsolo"](forced, 12 - 4))
    assert_no_leak(pb)


def test_cow_fork_speculative_rollback(m, rng):
    """Fork an exact replica, let the source run ahead, evict it: the
    checkpoint continues to the solo-run answer."""
    pb = paged(m, lanes=3, clock=lambda: 0.0)
    p = ints(rng, 6)
    src = pb.submit(p, 12)
    for _ in range(3):
        pb.step()
    ck = pb.fork(src, token=pb._lane_state[src].tokens[-1])
    for _ in range(2):
        pb.step()
    used = pb.allocator.stats()["used"]
    st_src = pb._lane_state[src]
    pb._finish(st_src.request_id, st_src.tokens, "cancelled",
               st_src.prompt_len)
    pb._vacate(src)
    assert pb.allocator.stats()["used"] < used
    np.testing.assert_array_equal(run_to_done(pb, ck), m["jsolo"](p, 12))
    assert_no_leak(pb)


def test_cow_fork_sampled_key_and_validation(m, rng):
    """On a sampling engine ``key=`` is the fork's seed: the fork is the
    port's solo generate of its transcript under that seed."""
    pb = paged(m, temperature=0.8)
    p = ints(rng, 5)
    src = pb.submit(p, 6, seed=3)
    pb.step()
    f = pb.fork(src, token=pb._lane_state[src].tokens[-1], key=9)
    o_src, o_f = run_to_done(pb, src), run_to_done(pb, f)
    np.testing.assert_array_equal(
        o_src, tsolo(m, p, 6, temperature=0.8, seed=3))
    kept = len(o_f) - 6 + 1                    # prompt + first emitted
    np.testing.assert_array_equal(
        o_f, tsolo(m, o_f[:kept], 5, temperature=0.8, seed=9))
    with pytest.raises(ValueError, match="empty"):
        pb.fork(0 if src != 0 else 1, token=1)
    greedy = paged(m)
    g = greedy.submit(p, 4)
    with pytest.raises(ValueError, match="sampling engine"):
        greedy.fork(g, token=1, key=0)
    with pytest.raises(ValueError, match="outside vocab"):
        greedy.fork(g, token=KW["vocab_size"])
    done = greedy.submit(p, 1)
    greedy.step()
    with pytest.raises(ValueError, match="already finished"):
        greedy.fork(done, token=1)
    chunked = paged(m, prefill_chunk=8, prompt_buckets=(8, 16))
    parked = chunked.submit(ints(rng, 22), 4)
    with pytest.raises(ValueError, match="still admitting"):
        chunked.fork(parked, token=1)
    elastic = paged(m, lane_tiers=(1, 2), max_queue=1)
    with pytest.raises(ValueError, match="elastic"):
        elastic.fork(0, token=1)


def test_cow_fork_backpressure(m, rng):
    """No free lane -> None; no free block for the tail copy -> None
    with every staged share rolled back."""
    pb = paged(m, n_blocks=4)
    p = ints(rng, 3)
    a = pb.submit(p, 5)
    b = pb.submit(ints(rng, 6), 2)
    pb.step()
    assert pb.fork(a, token=1) is None          # lanes full
    run_to_done(pb, b)
    while pb.allocator.alloc() is not None:
        pass
    st = pb.allocator.stats()
    assert pb.fork(a, token=1) is None
    assert pb.allocator.stats() == st           # rollback exact
    assert pb.last_request_id is None


# ------------------------------------- backpressure, OOM, eviction


def test_admission_oom_declines_then_queue_backpressure(m, rng):
    """Allocator exhausted at admission: bare submit declines (no lane,
    nothing leaked), enqueue queues the request and admits it once
    blocks free; past the queue cap, QueueFull naming the allocator."""
    pb = paged(m, lanes=3, n_blocks=3, max_queue=1)   # 2 usable blocks
    p1, p2, p3 = ints(rng, 5), ints(rng, 5), ints(rng, 5)
    l1, l2 = pb.submit(p1, 3), pb.submit(p2, 3)
    assert l1 is not None and l2 is not None
    assert pb.submit(p3, 3) is None              # blocks dry, lane free
    assert pb.last_request_id is None
    assert len(pb.free_lanes()) == 1
    r3 = pb.enqueue(p3, 3)                       # queues instead
    assert pb.queued == 1
    with pytest.raises(QueueFull, match="KV block allocator"):
        pb.enqueue(p3, 3)
    run_to_done(pb, l1)
    run_to_done(pb, l2)
    while pb.poll(r3) is None:
        pb.step()
    res = pb.take(r3)
    assert res.ok
    np.testing.assert_array_equal(res.tokens, m["jsolo"](p3, 3))
    assert_no_leak(pb)


def test_growth_oom_evicts_with_structured_error(m, rng):
    """A lane the allocator cannot grow is evicted with an "error"
    result; its freed blocks let the other lane finish exactly."""
    pb = paged(m, n_blocks=4)                  # 3 usable blocks
    p1, p2 = ints(rng, 7), ints(rng, 7)
    l1 = pb.submit(p1, 12)
    l2 = pb.submit(p2, 12)
    while pb.running():
        pb.step()
    evicted = [r for r in pb.results().values() if r.status == "error"]
    assert len(evicted) == 1
    assert "exhausted" in evicted[0].error
    survivor = l1 if pb._lane_state[l1] is not None else l2
    sp = p1 if survivor == l1 else p2
    np.testing.assert_array_equal(pb.drain(survivor), m["jsolo"](sp, 12))
    assert_no_leak(pb)


def test_chaos_eviction_mid_growth_shared_blocks_survive(m, rng):
    """A deadline-evicted lane mid-growth frees its PRIVATE blocks; the
    stem blocks it shared survive for the other lane, whose tokens stay
    JAX's, and nothing leaks."""
    t = {"now": 0.0}
    pb = paged(m, prompt_buckets=(4, 16), clock=lambda: t["now"])
    stem = ints(rng, 16)
    pr1 = np.concatenate([stem, ints(rng, 3)])
    pr2 = np.concatenate([stem, ints(rng, 3)])
    l1 = pb.submit(pr1, 10)
    l2 = pb.submit(pr2, 10, ttl=5.0)
    shared = pb._lane_blocks[l1][:2]
    assert pb._lane_blocks[l2][:2] == shared
    at_admission = len(pb._lane_blocks[l2])
    for _ in range(7):
        pb.step()
    assert len(pb._lane_blocks[l2]) > at_admission
    private = [b for b in pb._lane_blocks[l2] if b not in shared]
    assert private
    t["now"] = 6.0
    pb.step()                                  # reap evicts l2
    assert pb._lane_state[l2] is None
    assert all(pb.allocator.refs_of(b) == 0 for b in private)
    assert all(pb.allocator.refs_of(b) == 1 for b in shared)
    np.testing.assert_array_equal(run_to_done(pb, l1), m["jsolo"](pr1, 10))
    assert_no_leak(pb)


def test_abort_admission_releases_staged_blocks(m, rng):
    """A failure after block staging (the admit dispatch) rolls the
    staged blocks back: no half-admitted lane, no leak."""
    pb = paged(m)
    p = ints(rng, 9)

    def boom(*a, **kw):
        raise RuntimeError("injected admit fault")
    real_admit, pb._admit = pb._admit, boom
    with pytest.raises(RuntimeError, match="injected admit fault"):
        pb.submit(p, 4)
    assert_no_leak(pb)
    pb._admit = real_admit
    with pytest.raises(ValueError, match="seed iff"):
        pb.submit(p, 4, seed=0)                # greedy engine + seed
    assert_no_leak(pb)
    np.testing.assert_array_equal(run_to_done(pb, pb.submit(p, 4)),
                                  m["jsolo"](p, 4))


def test_shutdown_drains_and_frees(m, rng):
    pb = paged(m, max_queue=2)
    prompts = [ints(rng, 6) for _ in range(4)]
    rids = [pb.enqueue(p, 5) for p in prompts]
    res = pb.shutdown()
    assert sorted(res) == sorted(rids)
    assert all(r.ok for r in res.values())
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(res[rid].tokens, m["jsolo"](p, 5))
    assert_no_leak(pb)


def test_elastic_tiers_remap_tables_without_moving_the_slab(m, rng):
    """lane_tiers: a scale-up and a scale-down move rows only (the slab
    tensor is the same object), the tables follow the lanes, and every
    request's tokens are JAX's."""
    pb = paged(m, lane_tiers=(1, 2), max_queue=1, scale_up_after=1,
               scale_down_after=1, step_windows=(1, 2))
    assert pb.allocator.capacity == 2 * MB     # sized for the top tier
    slab = pb.cache["k"]
    prompts = [ints(rng, n) for n in (9, 5, 7)]
    rids = [pb.enqueue(prompts[0], 6), pb.enqueue(prompts[1], 5)]
    assert pb.queued == 1
    rids.append(pb.enqueue(prompts[2], 4))     # overflow: scale up
    assert pb.lanes == 2 and pb.tier_epoch == 1
    while any(pb.poll(r) is None for r in rids):
        pb.step(2)
    while pb.lanes > 1:
        pb.step(1)
    assert pb.cache["k"] is slab
    for rid, p, n in zip(rids, prompts, (6, 5, 4)):
        res = pb.take(rid)
        assert res.ok
        np.testing.assert_array_equal(res.tokens, m["jsolo"](p, n))
    assert_no_leak(pb)


# ------------------------------------------- kv_int8="prefill"


def test_kv_int8_prefill_admission_tolerance(m, rng):
    """A prefill-BUILT int8 cache (full-precision in-chunk attention,
    quantized once) differs from the decode-built one by a real but
    bounded amount on the first decode step's logits: nonzero and under
    KV_INT8_PREFILL_LOGIT_TOL, as the JAX package's reading is at the
    same inputs."""
    cfg, p = m["cfg"], m["p"]
    prompt = rng.integers(0, 64, (1, 17)).astype(np.int32)
    warm = torch.from_numpy(prompt[:, :-1]).long()
    w = warm.shape[1]
    cache_d = tgen.init_cache(cfg, 1, kv_int8=True, device="cpu")
    with torch.no_grad():
        tgen._decode_chunk(p, cache_d, warm, torch.zeros(1, dtype=torch.long),
                           cfg, uniform_pos=True)
    cache_p, _ = tgen.prefill(p, warm, cfg, last_logits=False, kv_int8=True,
                              device="cpu")
    pos = torch.full((1,), w, dtype=torch.long)
    last = torch.from_numpy(prompt[:, -1:]).long()
    with torch.no_grad():
        lg_d, _ = tgen._decode_chunk(p, cache_d, last, pos, cfg)
        lg_p, _ = tgen._decode_chunk(p, cache_p, last, pos, cfg)
    diff = float((lg_d - lg_p).abs().max())
    assert 0.0 < diff < KV_INT8_PREFILL_LOGIT_TOL, diff
    jcfg = m["jcfg"]

    @jax.jit
    def jax_logits(jp, warm, last):
        # The same two builds and first steps in the JAX package.
        _, jd = jgen._decode_chunk(jp, jgen.init_cache(jcfg, 1, kv_int8=True),
                                   warm, jnp.zeros((1,), jnp.int32), jcfg,
                                   uniform_pos=True)
        jpc, _ = jgen.prefill(jp, warm, jcfg, last_logits=False,
                              kv_int8=True)
        pos = jnp.full((1,), warm.shape[1], jnp.int32)
        return (jgen._decode_chunk(jp, jd, last, pos, jcfg)[0],
                jgen._decode_chunk(jp, jpc, last, pos, jcfg)[0])

    j_d, j_p = jax_logits(m["jp"], jnp.asarray(prompt[:, :-1]),
                          jnp.asarray(prompt[:, -1:]))
    j_diff = float(jnp.max(jnp.abs(j_d - j_p)))
    assert 0.0 < j_diff < KV_INT8_PREFILL_LOGIT_TOL, j_diff
    # The decode-built logits are the reference's (f32, 2e-4 as the JAX
    # tests hold a chunk to a step).
    np.testing.assert_allclose(lg_d.numpy(), np.asarray(j_d), atol=2e-4,
                               rtol=2e-4)


def test_kv_int8_prefill_engine_agreement(m, rng):
    """Engine level: kv_int8="prefill" admission serves tokens that
    track the decode-built engine (the reference's 0.9 agreement bound);
    a from-scratch admission goes through prefill, a stem-shared tail
    through the decode-built chunk."""
    p = ints(rng, 9)
    outs = {}
    for mode in (True, "prefill"):
        pb = paged(m, lanes=1, kv_int8=mode)
        calls = {"prefill": 0}
        if mode == "prefill":
            real = pb._admit_prefill

            def counted(*a):
                calls["prefill"] += 1
                return real(*a)
            pb._admit_prefill = counted
        outs[mode] = run_to_done(pb, pb.submit(p, 12))
        assert calls["prefill"] == (1 if mode == "prefill" else 0)
        assert_no_leak(pb)
    agree = np.mean(outs[True] == outs["prefill"])
    assert agree >= 0.9, (agree, outs)


def test_kv_int8_prefill_validation(m):
    with pytest.raises(ValueError, match="full-precision"):
        PagedBatcher(quantize_params(m["p"]), m["cfg"], block=BLOCK,
                     kv_int8="prefill", device="cpu")
    with pytest.raises(ValueError, match="kv_int8 must be"):
        PagedBatcher(m["p"], m["cfg"], block=BLOCK, kv_int8="decode",
                     device="cpu")
    with pytest.raises(ValueError, match="PagedBatcher"):
        ContinuousBatcher(m["p"], m["cfg"], kv_int8="prefill", device="cpu")


# -------------------------------------------------- validation, obs


def test_paged_constructor_validation(m):
    cfg = m["cfg"]
    with pytest.raises(ValueError, match="divide max_len"):
        PagedBatcher(m["p"], cfg, block=5, device="cpu")
    win = ttfm.TransformerConfig(**dict(KW, attention_window=16))
    with pytest.raises(ValueError, match="full-cache"):
        PagedBatcher(m["p"], win, block=8, device="cpu")
    with pytest.raises(ValueError, match="block must be >= 1"):
        PagedBatcher(m["p"], cfg, block=0, device="cpu")
    with pytest.raises(ValueError, match="n_blocks"):
        PagedBatcher(m["p"], cfg, block=8, n_blocks=1, device="cpu")
    with pytest.raises(NotImplementedError, match="A7b"):
        PagedBatcher(m["p"], cfg, block=8, plan=object(), device="cpu")
    pb = paged(m, lanes=1)
    # Disaggregated serving is ported: a one-block export round-trips
    # into another slab; below one block is the reference's ValueError.
    ship = pb.export_blocks([1] * 8)
    assert len(ship) == 1 and ship.hexes() == stem_hexes([1] * 8, 8)
    assert paged(m, lanes=1).import_blocks(ship)["blocks"] == 1
    with pytest.raises(ValueError, match="full block"):
        pb.export_blocks([1] * 7)
    with pytest.raises(NotImplementedError, match="A11"):
        pb.traced_for_analysis()


def test_memory_footprint_reads_the_live_slab(m):
    """kv_bytes is the slab's, one block over the monolithic engine's at
    the monolithic-equivalent n_blocks; params are counted alike."""
    pb = paged(m, lanes=2)
    cb = ContinuousBatcher(m["p"], m["cfg"], lanes=2, device="cpu")
    fp, fc = pb.memory_footprint(), cb.memory_footprint()
    assert fp["param_bytes"] == fc["param_bytes"] > 0
    per_block = fc["kv_bytes"] // (2 * KW["max_len"]) * BLOCK
    assert fp["kv_bytes"] == fc["kv_bytes"] + per_block
    assert fp["kv_bytes_per_device"] == fp["kv_bytes"]


def test_paged_obs_gauges_and_fork_counter(m, rng):
    """kv_blocks_used/free/shared gauges and the cow_forks counter flow
    through the standard registry."""
    sess = obs.enable()
    try:
        pb = paged(m, lanes=3, prompt_buckets=(4, 16))
        stem = ints(rng, 16)
        l1 = pb.submit(np.concatenate([stem, ints(rng, 3)]), 6)
        l2 = pb.submit(np.concatenate([stem, ints(rng, 3)]), 6)
        f = pb.fork(l1, token=int(pb._lane_state[l1].tokens[-1]))
        reg = sess.registry
        assert reg.gauge("serving.kv_blocks_used").value() > 0
        assert reg.gauge("serving.kv_shared_blocks").value() >= 2
        assert (reg.gauge("serving.kv_blocks_used").value()
                + reg.gauge("serving.kv_blocks_free").value()
                == pb.allocator.capacity)
        assert reg.counter("serving.cow_forks").value() == 1
        assert reg.counter("serving.stem_hit_blocks").value() >= 2
        for lane in (l1, l2, f):
            run_to_done(pb, lane)
        assert reg.gauge("serving.kv_blocks_used").value() == 0
        text = reg.render_text()
        assert "serving_kv_blocks_used" in text
        assert "serving_cow_forks" in text
    finally:
        obs.disable()
