"""The port's LM data path vs ``distkeras_tpu`` (CPU).

- ``BPETokenizer``: merges, ids, decoded text and ``encode_corpus`` rows
  equal JAX's on the native and on the pure-Python path, and a
  ``dkt-bpe-v1`` file written by either package loads in the other;
- the native loaders (``gather_rows``, ``gather_normalize_u8``) equal
  JAX's, and the port builds them into its own build directory;
- ``Prefetcher`` (order, close, exceptions, StopIteration) as
  ``tests/test_native.py`` holds the reference's, ``DeviceFeed`` on the
  CPU, and ``Dataset.batches(prefetch=2)`` equals ``prefetch=0``;
- ``LMTrainer`` over a ``Dataset`` with ``device_data=True`` (shuffled,
  and packed with grad_accum): ``history`` / ``eval_history`` equal the
  JAX trainer's on a one-device mesh at 1e-4, and bit-equal the port's
  streaming run; the staging guard; ``profile_dir`` writes a trace;
- ``save_lm``: the port's artefact loads in JAX's ``load_lm`` and JAX's
  in the port's.
"""

import dataclasses
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import native as jnative
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.data.prefetch import Prefetcher as JPrefetcher
from distkeras_tpu.data.tokenizer import BPETokenizer as JBPE
from distkeras_tpu.models import transformer as jtfm
from distkeras_tpu.parallel.mesh import MeshSpec, make_mesh
from distkeras_tpu.trainers import lm as jlm
from distkeras_tpu.utils import serialization as jser
from distkeras_tpu_torch import native as tnative
from distkeras_tpu_torch.data import packing as tpacking
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.data.prefetch import DeviceFeed, Prefetcher
from distkeras_tpu_torch.data.tokenizer import BPETokenizer
from distkeras_tpu_torch.models import transformer as ttfm
from distkeras_tpu_torch.ops import _build
from distkeras_tpu_torch.trainers import lm as tlm
from distkeras_tpu_torch.utils import serialization as tser

CORPUS = (
    "the quick brown fox jumps over the lazy dog. "
    "the quicker brown foxes jump over the lazier dogs. "
    "pack my box with five dozen liquor jugs. héllo wörld. "
) * 40
TEXT = "the lazy liquor jugs jumped over my box, héllo 中文"


@pytest.fixture
def python_paths(monkeypatch):
    """Both packages on their pure-Python tokenizer path."""
    monkeypatch.setattr(jnative, "_bpe_lib", None)
    monkeypatch.setattr(jnative, "_bpe_tried", True)
    monkeypatch.setitem(tnative._libs, "tokenizer", None)


def test_native_libraries_build_into_the_port_build_dir():
    assert tnative.bpe_lib() is not None, tnative.build_errors
    assert tnative.lib() is not None, tnative.build_errors
    for name in ("tokenizer", "dataloader"):
        path = tnative.library_path(name)
        assert path.exists() and path.parent == _build.BUILD_DIR
    assert not list(tnative.NATIVE_DIR.glob("*.so"))


@pytest.mark.parametrize("path", ["native", "python"])
def test_bpe_tokenizer_equals_jax(request, path):
    if path == "python":
        request.getfixturevalue("python_paths")
    ref = JBPE.train(CORPUS, vocab_size=330)
    tok = BPETokenizer.train(CORPUS, vocab_size=330)
    assert tok.last_path == path
    np.testing.assert_array_equal(tok.merges, ref.merges)
    assert tok.vocab_size == ref.vocab_size == 330
    ids = tok.encode(TEXT)
    assert ids.dtype == np.int32 and tok.last_path == path
    np.testing.assert_array_equal(ids, ref.encode(TEXT))
    assert tok.decode(ids) == ref.decode(ids) == TEXT
    assert tok.last_path == path
    np.testing.assert_array_equal(tok.decode_bytes(ids),
                                  ref.decode_bytes(ids))
    rows = tok.encode_corpus(CORPUS, seq_len=32)
    np.testing.assert_array_equal(rows, ref.encode_corpus(CORPUS, seq_len=32))
    assert rows.shape[1] == 33 and np.array_equal(rows[1:, 0], rows[:-1, -1])
    with pytest.raises(ValueError, match="one row needs"):
        tok.encode_corpus("ab", seq_len=32)
    with pytest.raises(ValueError, match="vocab_size must be"):
        BPETokenizer.train(CORPUS, vocab_size=100)


def test_bpe_native_and_python_paths_agree(monkeypatch):
    native = BPETokenizer.train(CORPUS, vocab_size=350)
    monkeypatch.setitem(tnative._libs, "tokenizer", None)
    py = BPETokenizer.train(CORPUS, vocab_size=350)
    assert (native.last_path, py.last_path) == ("native", "python")
    np.testing.assert_array_equal(native.merges, py.merges)
    ids_py = py.encode(TEXT)
    monkeypatch.undo()
    np.testing.assert_array_equal(native.encode(TEXT), ids_py)


def test_bpe_file_loads_in_both_packages(tmp_path):
    tok = BPETokenizer.train(CORPUS, vocab_size=300)
    mine, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    tok.save(mine)
    JBPE.train(CORPUS, vocab_size=300).save(theirs)
    assert json.load(open(mine)) == json.load(open(theirs))
    np.testing.assert_array_equal(JBPE.load(mine).merges, tok.merges)
    back = BPETokenizer.load(theirs)
    np.testing.assert_array_equal(back.encode(TEXT), tok.encode(TEXT))
    (tmp_path / "bad.json").write_text('{"format": "other"}')
    with pytest.raises(ValueError, match="dkt-bpe-v1"):
        BPETokenizer.load(str(tmp_path / "bad.json"))


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8])
def test_gather_rows_equals_jax(rng, dtype):
    src = (rng.normal(0, 100, (257, 5, 3))).astype(dtype)
    idx = rng.integers(0, 257, 123)
    np.testing.assert_array_equal(tnative.gather_rows(src, idx),
                                  jnative.gather_rows(src, idx))
    out = np.empty((123, 5, 3), dtype)
    assert tnative.gather_rows(src, idx, out=out) is out
    np.testing.assert_array_equal(out, src[idx])
    assert tnative.gather_rows(src, np.zeros(0, np.int64)).shape == (0, 5, 3)
    for bad in ([257], [-1]):
        with pytest.raises(IndexError):
            tnative.gather_rows(src, np.array(bad))
    with pytest.raises(ValueError, match="mismatch"):
        tnative.gather_rows(src, idx, out=np.empty((123, 5, 3), np.float64))


def test_gather_normalize_u8_equals_jax(rng, monkeypatch):
    src = rng.integers(0, 256, (100, 8, 8, 3)).astype(np.uint8)
    idx = rng.integers(0, 100, 40)
    ref = jnative.gather_normalize_u8(src, idx, scale=1 / 255.0, bias=-0.5)
    got = tnative.gather_normalize_u8(src, idx, scale=1 / 255.0, bias=-0.5)
    np.testing.assert_array_equal(got, ref)
    monkeypatch.setitem(tnative._libs, "dataloader", None)  # numpy path
    np.testing.assert_allclose(
        tnative.gather_normalize_u8(src, idx, scale=1 / 255.0, bias=-0.5),
        ref, atol=1e-6)
    np.testing.assert_array_equal(tnative.gather_rows(src, idx), src[idx])
    with pytest.raises(TypeError, match="uint8"):
        tnative.gather_normalize_u8(src.astype(np.int32), idx, 1.0)


@pytest.mark.parametrize("cls", [Prefetcher, JPrefetcher])
def test_prefetcher_order_and_stopiteration(cls):
    assert list(cls(iter(range(50)), depth=4)) == list(range(50))
    it = cls(iter([1, 2]))
    assert list(it) == [1, 2]
    for _ in range(2):  # and again, like any iterator
        with pytest.raises(StopIteration):
            next(it)


def test_prefetcher_close_and_exceptions():
    with pytest.raises(ValueError, match="depth"):
        Prefetcher([], depth=0)
    it = Prefetcher(iter(range(10_000)), depth=2)
    assert next(it) == 0
    it.close()
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)

    def bad():
        yield 1
        raise RuntimeError("boom")

    it = Prefetcher(bad())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        list(it)
    with pytest.raises(StopIteration):  # raised once, then exhausted
        next(it)

    release = threading.Event()

    def slow():
        yield 1
        release.wait(timeout=30)
        yield 2

    it = Prefetcher(slow(), depth=1)
    assert next(it) == 1
    got = []
    consumer = threading.Thread(target=lambda: got.append(list(it)))
    consumer.start()
    time.sleep(0.2)  # the consumer blocks in __next__
    it.close()
    consumer.join(timeout=5)
    release.set()
    assert not consumer.is_alive() and got == [[]]


def test_batches_prefetch_equals_plain(rng):
    x = rng.normal(size=(96, 4)).astype(np.float32)
    y = rng.integers(0, 3, 96)
    ds = Dataset.from_arrays(x, y)
    plain = list(ds.batches(16, window=2))
    pre = ds.batches(16, window=2, prefetch=2)
    assert isinstance(pre, Prefetcher)
    pre = list(pre)
    assert len(plain) == len(pre) == 3
    for (xa, ya), (xb, yb) in zip(plain, pre):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_device_feed_on_the_cpu_keeps_order():
    items = [(np.full((2, 2), i, np.float32), {"y": np.full((2,), i)})
             for i in range(7)]
    out = list(DeviceFeed(iter(items), depth=3, device="cpu"))
    assert len(out) == 7
    for i, (x, d) in enumerate(out):
        assert isinstance(x, torch.Tensor) and x.dtype == torch.float32
        assert float(x[0, 0]) == i and int(d["y"][0]) == i
    with pytest.raises(ValueError, match="depth"):
        DeviceFeed([], depth=0, device="cpu")


# ------------------------------------------------------------ LMTrainer

BASE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_len=32, rope=True)


def np_params(cfg):
    return jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(0), cfg))


def packed(rng, n_rows, seq):
    docs = [rng.integers(1, 64, size=int(n))
            for n in rng.integers(2, 14, size=4 * n_rows)]
    rows, seg = tpacking.pack_documents(docs, seq)
    return rows[:n_rows], seg[:n_rows]


@pytest.mark.parametrize("variant", ["dataset-shuffle", "packed-accum"])
def test_lm_trainer_device_data_over_a_dataset_equals_jax(rng, devices,
                                                          variant):
    jcfg = jtfm.TransformerConfig(**BASE, n_kv_heads=2)
    tcfg = ttfm.TransformerConfig(**BASE, n_kv_heads=2)
    params = np_params(jcfg)
    kw = dict(optimizer="adamw", learning_rate=3e-3, batch_size=2, seed=3,
              tokens_col="ids")
    if variant == "dataset-shuffle":
        tokens = rng.integers(0, 64, (9, 17)).astype(np.int32)
        evals = rng.integers(0, 64, (5, 17)).astype(np.int32)
        kw.update(shuffle=True, eval_every=2, num_epoch=2)
        args = dict(eval_tokens=evals)
    else:
        tokens, seg = packed(rng, 7, 16)
        evals, eseg = packed(np.random.default_rng(9), 4, 16)
        kw.update(eval_every=3, grad_accum=2, shuffle=True)
        args = dict(segments=seg, eval_tokens=evals, eval_segments=eseg)
    jt = jlm.LMTrainer(jcfg, mesh=make_mesh(MeshSpec(data=1),
                                            devices=devices[:1]),
                       device_data=True, **kw)
    jt.train(JDataset({"ids": tokens}),
             params=jax.tree.map(jnp.asarray, params), **args)
    runs = []
    for device_data in (True, False):
        tt = tlm.LMTrainer(tcfg, device="cpu", device_data=device_data, **kw)
        tt.train(Dataset({"ids": tokens}),
                 params=tser.params_from_numpy(params, "cpu"), **args)
        runs.append(tt)
    staged, streamed = runs
    assert staged.history == streamed.history  # the same rows, in order
    assert staged.eval_history == streamed.eval_history
    assert len(staged.history) == len(jt.history) > 0
    np.testing.assert_allclose(staged.history, jt.history, atol=1e-4,
                               rtol=1e-4)
    assert [r for r, _ in staged.eval_history] == \
        [r for r, _ in jt.eval_history]
    for (_, a), (_, b) in zip(staged.eval_history, jt.eval_history):
        np.testing.assert_allclose([a["loss"], a["perplexity"]],
                                   [b["loss"], b["perplexity"]], rtol=1e-4)


def test_lm_trainer_staging_guard(rng, monkeypatch):
    tcfg = ttfm.TransformerConfig(**BASE)
    tokens = rng.integers(0, 64, (8, 17)).astype(np.int32)
    monkeypatch.setattr(tlm, "_device_bytes_limit", lambda device: 600)
    t = tlm.LMTrainer(tcfg, batch_size=2, device_data=True, device="cpu")
    with pytest.raises(ValueError, match="device budget"):
        t.train(tokens)
    monkeypatch.setattr(tlm, "_device_bytes_limit", lambda device: None)
    monkeypatch.setattr(tlm, "_STAGING_SANITY_BYTES", 100)
    with pytest.warns(UserWarning, match="no memory budget"):
        t.train(tokens)


def test_lm_trainer_profile_dir_writes_a_trace(rng, tmp_path):
    tcfg = ttfm.TransformerConfig(**BASE)
    tokens = rng.integers(0, 64, (10, 17)).astype(np.int32)
    evals = rng.integers(0, 64, (2, 17)).astype(np.int32)
    out = tmp_path / "prof"
    t = tlm.LMTrainer(tcfg, batch_size=2, profile_dir=str(out),
                      profile_steps=2, eval_every=2, device="cpu")
    t.train(Dataset({"tokens": tokens}), eval_tokens=evals)
    assert len(t.history) == 5
    assert t.profile_path == str(out / "lm_trainer_rounds_2-3.trace.json")
    events = json.load(open(t.profile_path))["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    one = tlm.LMTrainer(tcfg, batch_size=10, profile_dir=str(tmp_path / "x"),
                        device="cpu")
    with pytest.warns(UserWarning, match="no profile was written"):
        one.train(tokens)
    assert one.profile_path is None and not (tmp_path / "x").exists()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_save_lm_loads_in_jax_and_back(rng, tmp_path, dtype):
    jcfg = jtfm.TransformerConfig(**BASE, n_kv_heads=2, remat=True,
                                  remat_policy="dots")
    tcfg = ttfm.TransformerConfig(**dataclasses.asdict(jcfg))
    params = np_params(jtfm.TransformerConfig(**BASE, n_kv_heads=2))
    tp = tser.params_from_numpy(params, "cpu", dtype=dtype)
    path = str(tmp_path / "port.npz")
    tser.save_lm(path, tp, tcfg)
    jp, jcfg2 = jser.load_lm(path)
    assert jcfg2 == jcfg
    flat = dict(ttfm.named_leaves(tser.params_to_numpy(tp)))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jflat) == len(flat)
    for keypath, leaf in jflat:
        name = "/".join(k.key for k in keypath)
        assert leaf.dtype == np.float32
        np.testing.assert_array_equal(leaf, flat[name])
    tokens = rng.integers(0, 64, (2, 9)).astype(np.int32)
    ref, _ = jtfm.apply(jp, tokens, jcfg2)
    back, cfg3 = tser.load_lm(path, device="cpu", dtype=dtype)
    assert cfg3 == tcfg and back["tok_emb"].dtype == dtype
    out, _ = ttfm.apply(back, tokens, cfg3, device="cpu")
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               atol=1e-4 if dtype == torch.float32 else 0.1)
    # And a JAX artefact into the port.
    jpath = str(tmp_path / "jax.npz")
    jser.save_lm(jpath, params, jcfg)
    tp2, tcfg2 = tser.load_lm(jpath, device="cpu")
    assert tcfg2 == tcfg
    for name, leaf in ttfm.named_leaves(tser.params_to_numpy(tp2)):
        np.testing.assert_array_equal(
            leaf, dict(ttfm.named_leaves(params))[name])
    assert not os.path.exists(str(tmp_path / "jax.npz.npz"))
