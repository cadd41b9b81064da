"""The port's LSTMs against the reference's (``distkeras_tpu/models/
rnn.py::FusedLSTM`` and ``keras.layers.LSTM``, JAX backend, CPU),
mirroring the six tests of ``tests/test_rnn.py``.

The same numpy inputs (B 4, T 16, E 8, H 8) and the same Keras weights
(carried as they are: both packages hold ``kernel [E, 4H]``,
``recurrent_kernel [H, 4H]``, ``bias [4H]``) go through the JAX layer and
the port's ``FusedLSTM`` and ``LSTM`` (``fused=False``, torch's fused
kernel).  Tolerances: states and sequences at 1e-5 (f32, summation order
only); the ``SingleTrainer`` run's history and weights at rtol 1e-4 /
atol 1e-5, the Keras trainers' tolerance of
``tests/test_torch_keras_trainers.py``.  That run uses sgd: adam's first
updates divide each gradient by its own magnitude (plus 1e-7), so an
embedding row with a near-zero gradient turns summation-order noise
into an lr-sized difference.
The reference test's adam run is mirrored as a learning check.
"""

import pickle

import numpy as np
import pytest
import torch

import distkeras_tpu as dk
import keras
import distkeras_tpu_torch as dkt
from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.models.rnn import FusedLSTM as JFusedLSTM
from distkeras_tpu_torch.models.rnn import LSTM, FusedLSTM

TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(return_sequences=False, units=8, seq=16, feat=8, seed=0):
    """The stock Keras LSTM and the reference's FusedLSTM on one input,
    holding the stock layer's weights."""
    x = np.random.default_rng(seed).normal(size=(4, seq, feat)).astype(
        np.float32)
    ref = keras.layers.LSTM(units, return_sequences=return_sequences)
    fused = JFusedLSTM(units, return_sequences=return_sequences)
    r = np.asarray(ref(x))
    fused(x)  # builds
    fused.set_weights(ref.get_weights())
    return ref, fused, x, r


def _port(cls, weights, return_sequences=False, units=8, feat=8):
    m = cls(units, return_sequences, input_dim=feat)
    dkt.set_weights(m, weights)
    return m


def _run(m, x):
    with torch.no_grad():
        return m(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("cls", [FusedLSTM, LSTM])
def test_matches_keras_last_state(cls):
    ref, fused, x, want = _pair()
    got = _run(_port(cls, ref.get_weights()), x)
    assert got.shape == want.shape == (4, 8)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(fused(x)), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("cls", [FusedLSTM, LSTM])
def test_matches_keras_sequences(cls):
    ref, fused, x, want = _pair(return_sequences=True)
    got = _run(_port(cls, ref.get_weights(), return_sequences=True), x)
    assert got.shape == want.shape == (4, 16, 8)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(fused(x)), atol=1e-5,
                               rtol=1e-5)


def test_weights_interchange_both_ways():
    ref, fused, x, _ = _pair()
    # Keras -> port: the three variables, in Keras' order and layout.
    port = _port(FusedLSTM, fused.get_weights())
    assert [n for n, _ in port.named_parameters()] == [
        "kernel", "recurrent_kernel", "bias"]
    assert [v.path.split("/")[-1] for v in fused.weights] == [
        "kernel", "recurrent_kernel", "bias"]
    # port -> stock Keras (fresh port weights, drawn by the zoo's init):
    m = dkt.zoo.imdb_lstm(vocab_size=32, embed_dim=8, lstm_units=8,
                          maxlen=16, seed=5)
    w = dkt.get_weights(m.lstm)
    ref.set_weights(w)
    np.testing.assert_allclose(np.asarray(ref(x)), _run(m.lstm, x),
                               atol=1e-5, rtol=1e-5)
    # The unfused module has the same variables and no fourth (torch's
    # second bias is made per call).
    unfused = dkt.zoo.imdb_lstm(vocab_size=32, embed_dim=8, lstm_units=8,
                                maxlen=16, seed=5, fused=False)
    assert [tuple(p.shape) for p in unfused.lstm.parameters()] == [
        (8, 32), (8, 32), (32,)] and list(unfused.buffers()) == []
    for a, b in zip(dkt.get_weights(unfused), dkt.get_weights(m)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(_run(unfused.lstm, x), _run(m.lstm, x),
                               atol=1e-5, rtol=1e-5)
    # The init is Keras': orthogonal recurrent kernel (its [H, 4H] rows
    # orthonormal), unit forget bias.
    rk = w[1]
    np.testing.assert_allclose(rk @ rk.T, np.eye(8), atol=1e-5)
    np.testing.assert_array_equal(w[2], np.r_[np.zeros(8), np.ones(8),
                                              np.zeros(16)])


@pytest.mark.parametrize("fused", [True, False])
def test_serialization_round_trip(fused):
    jm = jzoo.imdb_lstm(vocab_size=64, embed_dim=8, lstm_units=8, maxlen=12,
                        seed=0, fused=fused)
    tm = dkt.zoo.imdb_lstm(vocab_size=64, embed_dim=8, lstm_units=8,
                           maxlen=12, seed=1, fused=fused)
    dkt.set_weights(tm, jm.get_weights())
    blob = dkt.serialize_keras_model(tm)
    assert isinstance(blob["model"], str)
    clone = dkt.deserialize_keras_model(pickle.loads(pickle.dumps(blob)))
    x = np.random.default_rng(3).integers(0, 64, (4, 12)).astype(np.int32)
    want = np.asarray(jm(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        again = clone(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(again, got)
    for a, b in zip(blob["weights"], jm.get_weights()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fused", [True, False])
def test_trains_under_single_trainer(fused):
    # The reference test's data: label = (first token < vocab/2).
    vocab = 64
    x = np.random.default_rng(0).integers(0, vocab, (256, 12)).astype(
        np.int32)
    y = (x[:, 0] < vocab // 2).astype(np.int64)
    kw = dict(loss="binary_crossentropy", batch_size=32, num_epoch=1)

    def both(width, rows, epochs, **opt):
        jm = jzoo.imdb_lstm(vocab_size=vocab, embed_dim=width,
                            lstm_units=width, maxlen=12, seed=0,
                            fused=fused)
        tm = dkt.zoo.imdb_lstm(vocab_size=vocab, embed_dim=width,
                               lstm_units=width, maxlen=12, fused=fused)
        dkt.set_weights(tm, jm.get_weights())
        tt = dkt.SingleTrainer(tm, device="cpu",
                               **dict(kw, num_epoch=epochs, **opt))
        return jm, tt, tt.train(dkt.Dataset.from_arrays(x[:rows], y[:rows]))

    # 4 steps against the reference's trainer.
    sgd = dict(worker_optimizer="sgd", learning_rate=0.1)
    jm, tt, tout = both(8, 128, 1, **sgd)
    jt = dk.SingleTrainer(jm, **kw, **sgd)
    jout = jt.train(dk.Dataset.from_arrays(x[:128], y[:128]))
    assert len(tt.history) == len(jt.history) == 4
    np.testing.assert_allclose(tt.history, jt.history, **TOL)
    for a, b in zip(dkt.get_weights(tout), jout.get_weights()):
        np.testing.assert_allclose(a, b, **TOL)
    # The reference test's run (its model's initial weights carried
    # across): the port learns the rule.
    _, tl, _ = both(16, 256, 8, worker_optimizer="adam", learning_rate=1e-2)
    assert tl.history[-1] < tl.history[0] * 0.5, tl.history[::16]


def test_validation():
    for cls in (FusedLSTM, LSTM):
        with pytest.raises(ValueError, match="units"):
            cls(0, input_dim=4)
        with pytest.raises(ValueError, match="batch, time, features"):
            cls(4, input_dim=8)(torch.zeros(2, 8))
    with pytest.raises(ValueError, match="units"):
        JFusedLSTM(0)


@pytest.mark.parametrize("fused", [True, False])
def test_adag_and_predictor_match_reference(fused):
    """ADAG (window 2) on ``imdb_lstm``, then ``ModelPredictor``, against
    the reference's (one worker), at the Keras trainers' tolerance."""
    vocab = 64
    x = np.random.default_rng(1).integers(0, vocab, (128, 12)).astype(
        np.int32)
    y = (x[:, 0] < vocab // 2).astype(np.int64)
    jm = jzoo.imdb_lstm(vocab_size=vocab, embed_dim=8, lstm_units=8,
                        maxlen=12, seed=0, fused=fused)
    tm = dkt.zoo.imdb_lstm(vocab_size=vocab, embed_dim=8, lstm_units=8,
                           maxlen=12, fused=fused)
    dkt.set_weights(tm, jm.get_weights())
    kw = dict(loss="binary_crossentropy", worker_optimizer="sgd",
              learning_rate=0.1, batch_size=16, communication_window=2,
              num_workers=1)
    jout = dk.ADAG(jm, **kw).train(dk.Dataset.from_arrays(x, y))
    tt = dkt.ADAG(tm, device="cpu", **kw)
    tout = tt.train(dkt.Dataset.from_arrays(x, y))
    assert len(tt.history) == 4
    for a, b in zip(dkt.get_weights(tout), jout.get_weights()):
        np.testing.assert_allclose(a, b, **TOL)
    jp = dk.ModelPredictor(jout).predict(dk.Dataset.from_arrays(x, y))
    tp = dkt.ModelPredictor(tout, device="cpu").predict(
        dkt.Dataset.from_arrays(x, y))
    np.testing.assert_allclose(np.asarray(tp["prediction"]),
                               np.asarray(jp["prediction"]), **TOL)
