"""Port transformer trunk vs ``distkeras_tpu.models.transformer``.

The same weights (the JAX package's ``init_params``, carried across with
``params_from_numpy``) and tokens go through both ``apply``s; logits are
held at 1e-4 in f32.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.models import transformer as jtfm
from distkeras_tpu_torch.models import transformer as ttfm
from distkeras_tpu_torch.ops.attention import naive_attention
from distkeras_tpu_torch.utils.serialization import params_from_numpy

BASE = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_len=32)


def jax_params(cfg_kw, seed=0):
    jcfg = jtfm.TransformerConfig(**cfg_kw)
    params = jax.tree.map(np.asarray,
                          jtfm.init_params(jax.random.key(seed), jcfg))
    return jcfg, ttfm.TransformerConfig(**cfg_kw), params


@pytest.mark.parametrize("extra", [
    dict(),                                    # learned positions
    dict(rope=True),
    dict(rope=True, n_kv_heads=2),             # GQA
    dict(rope=True, attention_window=5),
    dict(dtype="bfloat16"),                    # f32 weights: f32 trunk
], ids=["learned", "rope", "gqa", "window", "bf16-cfg"])
def test_apply_logits_match_jax(rng, extra):
    jcfg, tcfg, params = jax_params({**BASE, **extra})
    tokens = rng.integers(0, 128, (2, 24)).astype(np.int32)
    ref, _ = jtfm.apply(params, tokens, jcfg)
    out, aux = ttfm.apply(params_from_numpy(params, "cpu"), tokens, tcfg,
                          device="cpu")
    assert out.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_pieces_match_jax(rng):
    """rms-norm dtype promotion and the rope rotation, piece by piece."""
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    import jax.numpy as jnp

    for xd, sd in [(jnp.bfloat16, jnp.float32), (jnp.float32, jnp.float32),
                   (jnp.bfloat16, jnp.bfloat16)]:
        ref = jtfm._rms_norm(jnp.asarray(x, xd), jnp.asarray(scale, sd))
        out = ttfm._rms_norm(
            torch.from_numpy(x).to(getattr(torch, jnp.dtype(xd).name)),
            torch.from_numpy(scale).to(getattr(torch, jnp.dtype(sd).name)))
        assert str(out.dtype).endswith(jnp.dtype(ref.dtype).name)
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32), atol=1e-5)
    pos = np.arange(7)
    ang = ttfm.rope_angles(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(
        ang.numpy(), np.asarray(jtfm.rope_angles(jnp.asarray(pos), 16,
                                                 10000.0)), rtol=1e-6)
    q = rng.normal(size=(1, 7, 2, 16)).astype(np.float32)
    np.testing.assert_allclose(
        ttfm.rope_rotate(torch.from_numpy(q), ang[None, :, None]).numpy(),
        np.asarray(jtfm.rope_rotate(q, np.asarray(ang)[None, :, None])),
        atol=1e-5)


def test_custom_attention_fn_and_window_guard(rng):
    _, tcfg, params = jax_params({**BASE, "rope": True})
    tp = params_from_numpy(params, "cpu")
    tokens = rng.integers(0, 128, (2, 16))
    naive = lambda q, k, v: naive_attention(q, k, v, causal=True)
    ref, _ = ttfm.apply(tp, tokens, tcfg, device="cpu")
    out, _ = ttfm.apply(tp, tokens, tcfg, attention_fn=naive, device="cpu")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)
    wcfg = dataclasses.replace(tcfg, attention_window=4)
    with pytest.raises(ValueError, match="window mismatch"):
        ttfm.apply(tp, tokens, wcfg, attention_fn=naive, device="cpu")


def test_init_params_layout_matches_jax_and_unported_configs_raise():
    jcfg, tcfg, jp = jax_params({**BASE, "n_kv_heads": 2})
    tp = ttfm.init_params(0, tcfg, device="cpu")
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)
    assert shapes(tp) == shapes(jp)
    assert all(a.dtype == torch.float32
               for a in jax.tree.leaves(tp))
    again = ttfm.init_params(0, tcfg, device="cpu")
    assert torch.equal(tp["tok_emb"], again["tok_emb"])
    moe = {**BASE, "num_experts": 2, "moe_top_k": 2}
    jmoe = jax.tree.map(np.asarray, jtfm.init_params(
        jax.random.key(0), jtfm.TransformerConfig(**moe)))
    assert shapes(ttfm.init_params(0, ttfm.TransformerConfig(**moe),
                                   device="cpu")) == shapes(jmoe)
    with pytest.raises(ValueError, match="moe_top_k"):
        ttfm.init_params(0, ttfm.TransformerConfig(**{**moe,
                                                      "moe_top_k": 3}),
                         device="cpu")
    with pytest.raises(ValueError, match="even head_dim"):
        ttfm.init_params(0, ttfm.TransformerConfig(
            **{**BASE, "n_heads": 32}, rope=True), device="cpu")
    with pytest.raises(TypeError, match="dropout_rng"):
        ttfm.apply(tp, np.zeros((1, 4), np.int32), tcfg, dropout_rng=1,
                   device="cpu")
