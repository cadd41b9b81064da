"""Port attention tiers vs the JAX package's, on the same numpy inputs.

naive / blockwise / attention_chunk are held at 1e-5 (f32), the port's
CPU ``flash_attention`` against the Pallas ``_flash_kernel`` run by the
TPU interpreter at 1e-4 (the tolerances of tests/test_attention.py).
The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from distkeras_tpu.ops import attention as jattn
from distkeras_tpu_torch.ops import attention as tattn


def qkv(rng, b=2, l=32, h=2, d=8, lk=None):
    shape_q = (b, l, h, d)
    shape_k = (b, lk or l, h, d)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in (shape_q, shape_k, shape_k))


def t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


TIER_CASES = [
    dict(causal=False),
    dict(causal=True),
    dict(causal=True, window=5),
    dict(causal=True, window=12),
    dict(causal=True, q_offset=8, kv_offset=0),
]


@pytest.mark.parametrize("kw", TIER_CASES)
def test_naive_matches_jax(rng, kw):
    q, k, v = qkv(rng)
    ref = jattn.naive_attention(q, k, v, **kw)
    out = tattn.naive_attention(*t(q, k, v), **kw)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kw", TIER_CASES)
@pytest.mark.parametrize("block_k", [8, 12])
def test_blockwise_matches_jax(rng, kw, block_k):
    q, k, v = qkv(rng)
    ref = jattn.blockwise_attention(q, k, v, block_k=block_k, **kw)
    out = tattn.blockwise_attention(*t(q, k, v), block_k=block_k, **kw)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_blockwise_segments_and_cross_attention_match_jax(rng):
    q, k, v = qkv(rng, l=16)
    seg = np.repeat(np.array([[1, 2], [1, 1]]), 8, axis=1).astype(np.int32)
    ref = jattn.blockwise_attention(q, k, v, causal=True, block_k=4,
                                    segment_ids=seg)
    out = tattn.blockwise_attention(*t(q, k, v), causal=True, block_k=4,
                                    segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    q, k, v = qkv(rng, l=16, lk=48)
    np.testing.assert_allclose(
        tattn.blockwise_attention(*t(q, k, v), block_k=16).numpy(),
        jattn.naive_attention(q, k, v), atol=1e-5, rtol=1e-5)


def test_attention_chunk_state_matches_jax(rng):
    q, k, v = qkv(rng, l=16)
    scale = 1.0 / np.sqrt(8)
    jstate = jattn.online_init(2, 2, 16, 8)
    tstate = tattn.online_init(2, 2, 16, 8)
    for start in (0, 8):
        sl = slice(start, start + 8)
        jstate = jattn.attention_chunk(q, k[:, sl], v[:, sl], *jstate, True,
                                       scale, 0, start, 6)
        tstate = tattn.attention_chunk(*t(q, k[:, sl], v[:, sl]), *tstate,
                                       True, scale, 0, start, 6)
    for a, b in zip(tstate, jstate):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tattn.online_finish(*tstate).numpy(),
                               jattn.online_finish(*jstate),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 5), (True, 12)])
def test_cpu_flash_matches_pallas_kernel(rng, causal, window):
    """The port's CPU flash path against the TPU kernel's own logic (the
    Pallas interpreter), d=128, l=16, blocks of 8."""
    q, k, v = qkv(rng, b=1, l=16, h=1, d=128)
    scale = 1.0 / np.sqrt(128)
    ref, _ = jattn._flash_pallas(q, k, v, causal, scale, block_q=8,
                                 block_k=8, interpret=True, with_lse=False,
                                 window=window)
    out = tattn.flash_attention(*t(q, k, v), causal, window=window)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_cpu_flash_gqa_matches_pallas_kernel(rng):
    """GQA: one shared K/V head repeated to the two query heads before
    the kernel, as the transformer block does."""
    q, _, _ = qkv(rng, b=1, l=16, h=2, d=128)
    _, k, v = qkv(rng, b=1, l=16, h=1, d=128)
    k, v = np.repeat(k, 2, axis=2), np.repeat(v, 2, axis=2)
    ref, _ = jattn._flash_pallas(q, k, v, True, 1.0 / np.sqrt(128),
                                 block_q=8, block_k=8, interpret=True,
                                 with_lse=False)
    out = tattn.flash_attention(*t(q, k, v), True)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_flash_window_guard_and_cpu_path_launches_nothing(rng):
    q, k, v = t(*qkv(rng))
    with pytest.raises(ValueError, match="requires causal"):
        tattn.flash_attention(q, k, v, False, window=4)
    with pytest.raises(ValueError, match=">= 1"):
        tattn.flash_attention(q, k, v, True, window=0)
    before = dict(tattn.LAUNCHES)
    tattn.flash_attention(q, k, v, True)
    assert tattn.LAUNCHES == before


def test_kernel_wrapper_rejects_cpu_tensors(rng):
    """The CUDA wrapper never takes the plain version: a CPU tensor is an
    error there, before any build or launch."""
    q, k, v = t(*qkv(rng, d=128))
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tattn.flash_fwd_cuda(q, k, v, True, 0.1)
