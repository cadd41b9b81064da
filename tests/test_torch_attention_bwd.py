"""The port's training attention vs the JAX package's, on the same numpy
inputs: the forward with lse, the plain FA2 backward (the CUDA kernels'
twins) and ``flash_attention`` gradients on the CPU.

Tolerances are those of tests/test_attention.py: 1e-4 for the forward
and its lse against the Pallas ``_flash_kernel`` run by the TPU
interpreter, 2e-3 for the backward against ``_flash_pallas_bwd`` (the
Pallas dQ and dK/dV kernels, interpreted) and against ``jax.grad``.
The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops import attention as jattn
from distkeras_tpu_torch.ops import attention as tattn

D = 128


def t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def inputs(rng, b=1, l=32, h=2, d=D):
    return tuple(rng.normal(size=(b, l, h, d)).astype(np.float32)
                 for _ in range(4))


def segments(b, l):
    """Packed rows: a boundary inside the first block, unequal lengths,
    and padding (segment 0) at the end of the last row."""
    seg = np.zeros((b, l), np.int32)
    for row in range(b):
        cuts = [0, 5 + row, 19, l]
        for sid, (a, e) in enumerate(zip(cuts, cuts[1:]), start=1):
            seg[row, a:e] = sid
    seg[-1, -3:] = 0
    return seg


# (causal, window, block_q, block_k, segmented): window below and above
# the block, asymmetric blocks (the banded dK/dV walk), segments.
CASES = [
    (False, None, 8, 8, False),
    (True, None, 8, 8, False),
    (True, 5, 8, 8, False),
    (True, 12, 8, 8, False),
    (True, 12, 16, 8, False),
    (True, 12, 8, 16, False),
    (True, None, 8, 8, True),
    (False, None, 16, 8, True),
    (True, 20, 8, 16, True),
]
IDS = ["full", "causal", "win5", "win12", "win12-bq16", "win12-bk16",
       "seg", "seg-noncausal", "seg-win20"]


def pallas(q, k, v, g, causal, window, bq, bk, seg):
    """The JAX package's Pallas forward (with lse) and backward, run by
    the TPU interpreter."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    out, lse = jattn._flash_pallas(q, k, v, causal, scale, bq, bk,
                                   interpret=True, with_lse=True,
                                   window=window, segment_ids=seg)
    grads = jattn._flash_pallas_bwd(q, k, v, np.asarray(out), lse, g, causal,
                                    scale, bq, bk, interpret=True,
                                    window=window, segment_ids=seg)
    b, l, h, _ = q.shape
    return (np.asarray(out), np.asarray(lse).reshape(b, h, l),
            *map(np.asarray, grads))


@pytest.mark.parametrize("causal,window,bq,bk,segmented", CASES, ids=IDS)
def test_plain_fwd_and_bwd_match_pallas_kernels(rng, causal, window, bq, bk,
                                                segmented):
    q, k, v, g = inputs(rng)
    seg = segments(1, 32) if segmented else None
    out, lse, dq, dk, dv = pallas(q, k, v, g, causal, window, bq, bk, seg)
    scale = 1.0 / np.sqrt(D)
    tseg = None if seg is None else torch.from_numpy(seg)
    tq, tk, tv, tg = t(q, k, v, g)
    t_out, t_lse = tattn.flash_fwd_plain(tq, tk, tv, causal, scale, window,
                                         tseg)
    np.testing.assert_allclose(t_out.numpy(), out, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_lse.numpy(), lse, atol=1e-4, rtol=1e-4)
    # The backward from the same (out, lse) residuals as the Pallas one;
    # chunks of 8 exercise the chunked loops.
    delta = tattn.attention_delta(tg, *t(out))
    t_lse, = t(lse)
    t_dq = tattn.flash_bwd_dq_plain(tq, tk, tv, tg, t_lse, delta, causal,
                                    scale, window, tseg, block=8)
    t_dk, t_dv = tattn.flash_bwd_dkv_plain(tq, tk, tv, tg, t_lse, delta,
                                           causal, scale, window, tseg,
                                           block=8)
    for got, ref in ((t_dq, dq), (t_dk, dk), (t_dv, dv)):
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("causal,window,segmented", [
    (False, None, False), (True, None, False), (True, 6, False),
    (True, None, True), (True, 9, True)])
def test_cpu_flash_attention_grads_match_jax(rng, causal, window, segmented):
    """CPU ``flash_attention`` (the blockwise tier under autograd) against
    ``jax.grad`` of the JAX ``flash_attention`` (its fallback VJP), at
    2e-3, with a small kv chunk so the online recurrence spans chunks."""
    q, k, v, g = inputs(rng, b=2, l=24, h=2, d=16)
    seg = segments(2, 24) if segmented else None

    def jloss(q, k, v):
        out = jattn.flash_attention(q, k, v, causal, block_k=8,
                                    window=window, segment_ids=seg)
        return jnp.sum(out * g)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    leaves = [x.requires_grad_() for x in t(q, k, v)]
    out = tattn.flash_attention(*leaves, causal, block_k=8, window=window,
                                segment_ids=None if seg is None
                                else torch.from_numpy(seg))
    (out * torch.from_numpy(g)).sum().backward()
    for got, r in zip(leaves, ref):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(r),
                                   atol=2e-3, rtol=2e-3)


def test_fully_masked_rows_rebuild_the_reference_probabilities(rng):
    """A query whose keys are all masked (window, with a q offset the
    model never builds) keeps m = NEG_INF, so lse = NEG_INF + log n
    rounds to NEG_INF in f32 and the backward rebuilds p = 1 on each
    masked entry — the reference's arithmetic, kept by the plain FA2
    (the kernels skip the dead tiles instead, ROADMAP C)."""
    q, k, v, g = (torch.from_numpy(a) for a in inputs(rng, l=8, d=16))
    scale = 0.25
    m, l, _ = tattn._online(q, k, v, True, scale, 8, 16, 0, 2, None)
    lse = m + torch.log(torch.where(l == 0, 1.0, l))
    assert torch.all(lse == tattn.NEG_INF)
    p = tattn._fa2_probs(q, k, lse, True, scale, 2, 16, 0, None, None)
    assert torch.all(p == 1.0)


def test_kernel_wrappers_reject_cpu_tensors_and_bad_segments(rng):
    """The CUDA wrappers never take the plain version: a CPU tensor is an
    error there, before any build or launch; segment ids must be
    [B, L] with lq == lkv."""
    q, k, v, g = t(*inputs(rng, d=64))
    lse = delta = torch.zeros(1, 2, 32)
    for call in (
            lambda: tattn.flash_bwd_dq_cuda(q, k, v, g, lse, delta, True,
                                            0.1),
            lambda: tattn.flash_bwd_dkv_cuda(q, k, v, g, lse, delta, True,
                                             0.1),
            lambda: tattn.flash_fwd_cuda(q, k, v, True, 0.1, with_lse=True)):
        with pytest.raises(ValueError, match="not a CUDA tensor"):
            call()
    with pytest.raises(ValueError, match="segment_ids"):
        tattn._kernel_segments(torch.zeros(1, 31, dtype=torch.int32), q, k)
    with pytest.raises(ValueError, match="segment_ids"):
        tattn.flash_fwd_plain(q, k[:, :16], v[:, :16], False, 0.1,
                              segment_ids=torch.zeros(1, 16))
