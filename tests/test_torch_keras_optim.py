"""The port's losses and optimizers against ``distkeras_tpu``'s, on the
same numpy inputs (CPU, float32).

- The seven loss names of ``resolve_loss`` (crossentropies from logits
  and from probabilities) at 1e-6.
- The seven optimizer names of ``resolve_optimizer`` at their default
  learning rates, sgd with Nesterov momentum (EAMSGD's) and adam on a
  schedule, against optax over 5 steps on the same gradients at 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.ops import losses as jlosses
from distkeras_tpu.ops import optimizers as joptim
from distkeras_tpu_torch.ops import losses as tlosses
from distkeras_tpu_torch.ops import optimizers as toptim
from distkeras_tpu_torch.trainers.optim import Optimizer


def loss_inputs(name, rng):
    logits = rng.normal(size=(16, 5)).astype(np.float32) * 3
    if name == "sparse_categorical_crossentropy":
        return rng.integers(0, 5, 16), logits
    if name == "categorical_crossentropy":
        return np.eye(5, dtype=np.float32)[rng.integers(0, 5, 16)], logits
    if name == "binary_crossentropy":
        return rng.integers(0, 2, 16).astype(np.float32), logits[:, :1]
    return rng.normal(size=(16, 3)).astype(np.float32), logits[:, :3]


@pytest.mark.parametrize("name", sorted(jlosses._LOSSES))
def test_losses_match_jax(name):
    rng = np.random.default_rng(0)
    y, p = loss_inputs(name, rng)
    jfn, tfn = jlosses.resolve_loss(name), tlosses.resolve_loss(name)
    want = float(jfn(jnp.asarray(y), jnp.asarray(p)))
    got = tfn(torch.from_numpy(y), torch.from_numpy(p))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6)
    if "crossentropy" in name:  # probabilities, with the 1e-7 clips
        if name == "binary_crossentropy":
            prob = 1 / (1 + np.exp(-p))
            prob[0] = 0.0
        else:
            prob = np.exp(p) / np.exp(p).sum(-1, keepdims=True)
            prob[0, :] = 0.0
        want = float(jfn(jnp.asarray(y), jnp.asarray(prob), from_logits=False))
        got = tfn(torch.from_numpy(y), torch.from_numpy(prob),
                  from_logits=False)
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6)


def test_loss_contracts():
    bce = tlosses.resolve_loss("binary_crossentropy")
    with pytest.raises(ValueError, match="incompatible"):
        bce(torch.zeros(4), torch.zeros(4, 2))
    with pytest.raises(ValueError, match="incompatible"):
        jlosses.resolve_loss("mse")(jnp.zeros(4), jnp.zeros((4, 2)))
    with pytest.raises(ValueError, match="incompatible"):
        tlosses.resolve_loss("mse")(torch.zeros(4), torch.zeros(4, 2))
    with pytest.raises(ValueError, match="known: .*mean_absolute_error"):
        tlosses.resolve_loss("hinge")
    fn = lambda y, p: (p - y).sum()
    assert tlosses.resolve_loss(fn) is fn


def run_optax(tx, params, grads):
    state = tx.init(params)
    for g in grads:
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return [np.asarray(p) for p in params]


def run_port(opt, params, grads):
    leaves = [torch.from_numpy(p.copy()) for p in params]
    state = opt.init(leaves)
    for g in grads:
        for p, gi in zip(leaves, g):
            p.grad = torch.from_numpy(gi.copy())
        opt.update(leaves, state)
    return [p.detach().numpy() for p in leaves]


def sched(count):
    return 0.05 * 0.7 ** count


OPTIMIZERS = [(name, None) for name in sorted(toptim.DEFAULT_LEARNING_RATES)]
OPTIMIZERS += [("sgd_nesterov", None), ("adam_schedule", sched)]


@pytest.mark.parametrize("name,lr", OPTIMIZERS)
def test_optimizers_match_optax(name, lr):
    rng = np.random.default_rng(1)
    params = [rng.normal(size=(5, 7)).astype(np.float32),
              rng.normal(size=(7,)).astype(np.float32)]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in params]
             for _ in range(5)]
    if name == "sgd_nesterov":
        tx = optax.sgd(0.05, momentum=0.9, nesterov=True)
        opt = toptim.resolve_optimizer(
            Optimizer("sgd", 0.05, momentum=0.9, nesterov=True))
    elif name == "adam_schedule":
        tx = joptim.resolve_optimizer("adam", lr)
        opt = toptim.resolve_optimizer("adam", lr)
    else:
        tx = joptim.resolve_optimizer(name)
        opt = toptim.resolve_optimizer(name)
    want = run_optax(tx, [jnp.asarray(p) for p in params], grads)
    got = run_port(opt, params, grads)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    # The step moved the params by more than the tolerance.
    assert np.abs(want[0] - params[0]).max() > 1e-4


def test_optimizer_contracts():
    assert toptim.resolve_optimizer("ADAM").learning_rate == 0.001
    assert toptim.resolve_optimizer("adadelta").learning_rate == 1.0
    assert toptim.resolve_optimizer("sgd", 0.3).learning_rate == 0.3
    opt = Optimizer("adagrad", 0.1)
    assert toptim.resolve_optimizer(opt) is opt
    with pytest.raises(ValueError, match="known: .*rmsprop"):
        toptim.resolve_optimizer("lamb")
    with pytest.raises(ValueError, match="positive"):
        toptim.resolve_optimizer("sgd", 0.0)
    with pytest.raises(TypeError, match="name or an Optimizer"):
        toptim.resolve_optimizer(3)
    with pytest.raises(ValueError, match="only apply to optimizer='sgd'"):
        Optimizer("adam", 0.1, momentum=0.9)
