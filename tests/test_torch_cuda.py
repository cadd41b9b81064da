"""The port's CUDA kernels against their plain versions, on the card:
the flash forward (inference and training launches), the FA2 dQ and
dK/dV kernels, and ``flash_attention`` under autograd; and the Keras
family's CIFAR CNN path on the card against the same path on the CPU.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports no JAX, so on a machine with
the card and without JAX it runs with the suite's conftest switched off:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.ops import attention as tattn

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal,window,lq,lk,d", [
    (True, None, 200, 200, 128),
    (True, 37, 130, 130, 128),
    (False, None, 70, 190, 64),
    (True, None, 1, 65, 64),
])
def test_flash_kernel_matches_plain(cuda, dtype, tol, causal, window, lq,
                                    lk, d):
    """Ragged lengths (not multiples of the 64-row tiles), both head
    dims, causal / banded / non-causal.  f32: summation order only;
    bf16: the kernel rounds P to bf16 before P.V (tensor cores)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, lq, 3, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, lk, 3, d))
                             .astype(np.float32)) for _ in range(2))
    q, k, v = (x.to("cuda", dtype) for x in (q, k, v))
    before = tattn.LAUNCHES["flash_fwd"]
    with torch.no_grad():
        out = tattn.flash_attention(q, k, v, causal, window=window)
        ref = tattn.blockwise_attention(q, k, v, causal, window=window)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES["flash_fwd"] == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_flash_kernel_strided_inputs_and_rejections(cuda):
    """Views with unit head_dim stride launch without a copy; what the
    kernel does not take raises instead of falling back."""
    base = torch.randn(2, 64, 6, 128, device="cuda")
    q, k = base[:, :, :3], base[:, :, 3:]
    with torch.no_grad():
        out = tattn.flash_attention(q, k, k, True)
        ref = tattn.blockwise_attention(q, k, k, True)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    # bf16 rows 386 elements apart: not 16-byte aligned, element loads.
    flat = torch.randn(2 * 64 * 386, device="cuda", dtype=torch.bfloat16)
    x = torch.as_strided(flat, (2, 64, 3, 128), (64 * 386, 386, 128, 1))
    with torch.no_grad():
        out = tattn.flash_attention(x, x, x, True)
        ref = tattn.blockwise_attention(x, x, x, True)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_attention(*(torch.randn(1, 8, 2, 32, device="cuda"),) * 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        x = torch.randn(1, 8, 2, 64, device="cuda", dtype=torch.float16)
        tattn.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="scale must be positive"):
        x = torch.randn(1, 8, 2, 64, device="cuda")
        tattn.flash_attention(x, x, x, scale=-0.1)
    with pytest.raises(ValueError, match="segment_ids"):
        x = torch.randn(1, 8, 2, 64, device="cuda", requires_grad=True)
        tattn.flash_attention(x, x, x, segment_ids=torch.zeros(
            1, 9, dtype=torch.int32, device="cuda"))


def _inputs(b, lq, lk, h, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.normal(size=(b, lq, h, d))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(b, lk, h, d))
                             .astype(np.float32)) for _ in range(2))
    return [x.to("cuda", dtype) for x in (q, k, v, do)]


def _segments(b, l, seed=0):
    """Packed rows: random segment lengths, with a boundary inside the
    first 64-row tile (the first-tile wipe case) and padding (0) at the
    end of the last row."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, l), np.int32)
    for row in range(b):
        pos, sid = 0, 1
        lens = [17] + list(rng.integers(5, 90, size=l))
        for n in lens:
            seg[row, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
            if pos >= l:
                break
    seg[-1, -7:] = 0
    return torch.from_numpy(seg).to("cuda")


# (causal, window, lq, lk, d, segmented): ragged lengths, both head dims,
# window below / above / not a multiple of the 64-row tile; a single
# partial tile (40) and exactly one full tile (64); many tiles under a
# window smaller than one tile, so the tile stream passes every stage of
# its ring many times; a window of several tiles over a long sequence,
# and a long non-causal kv sweep at head_dim 64, so the forward's K/V
# ring wraps many times within one block.
BWD_CASES = [
    (True, None, 200, 200, 128, False),
    (True, 37, 130, 130, 128, False),
    (True, 100, 257, 257, 64, False),
    (True, 90, 200, 200, 128, True),
    (False, None, 70, 190, 64, False),
    (False, None, 150, 150, 128, True),
    (True, None, 200, 200, 64, True),
    (True, None, 40, 40, 128, False),
    (False, None, 64, 64, 64, False),
    (True, 20, 520, 520, 128, False),
    (True, 300, 1000, 1000, 128, False),
    (False, None, 130, 900, 64, False),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal,window,lq,lk,d,segmented", BWD_CASES)
def test_flash_fwd_lse_and_segments_match_plain(cuda, dtype, tol, causal,
                                                window, lq, lk, d,
                                                segmented):
    """The training forward (lse, segment mask) against flash_fwd_plain:
    O at the forward's tolerance, lse at 1e-4 (f32) / 2e-2 (bf16 P)."""
    q, k, v, _ = _inputs(2, lq, lk, 3, d, dtype)
    seg = _segments(2, lq) if segmented else None
    scale = d ** -0.5
    out, lse = tattn.flash_fwd_cuda(q, k, v, causal, scale, window, seg,
                                    with_lse=True)
    ref, ref_lse = tattn.flash_fwd_plain(q, k, v, causal, scale, window, seg)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal,window,lq,lk,d,segmented", BWD_CASES)
def test_flash_bwd_kernels_match_plain(cuda, dtype, tol, causal, window, lq,
                                       lk, d, segmented):
    """dQ and dK/dV kernels against the plain FA2 versions on the same
    lse / delta.  f32: 3xTF32 products (~2^-21 of each product) and the
    summation order; bf16: P and dS rounded to bf16 as tensor-core
    operands, and the outputs rounded once to bf16."""
    q, k, v, do = _inputs(2, lq, lk, 3, d, dtype, seed=1)
    seg = _segments(2, lq, seed=1) if segmented else None
    scale = d ** -0.5
    out, lse = tattn.flash_fwd_plain(q, k, v, causal, scale, window, seg)
    delta = tattn.attention_delta(do, out)
    n = dict(tattn.LAUNCHES)
    dq = tattn.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale,
                                 window, seg)
    dk, dv = tattn.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale,
                                      window, seg)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES["flash_bwd_dq"] == n["flash_bwd_dq"] + 1
    assert tattn.LAUNCHES["flash_bwd_dkv"] == n["flash_bwd_dkv"] + 1
    ref_dq = tattn.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale,
                                      window, seg)
    ref_dk, ref_dv = tattn.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                               causal, scale, window, seg)
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)


def _bwd_pair(q, k, v, do, lse, delta, causal=True, window=None, seg=None):
    scale = q.shape[-1] ** -0.5
    dq = tattn.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale,
                                 window, seg)
    dk, dv = tattn.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale,
                                      window, seg)
    return dq, dk, dv


def _bwd_plain(q, k, v, do, lse, delta, causal=True, window=None, seg=None):
    scale = q.shape[-1] ** -0.5
    dq = tattn.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale,
                                  window, seg)
    return (dq, *tattn.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                           scale, window, seg))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("row_pad", [0, 2])
def test_flash_bwd_fused_qkv_strides(cuda, dtype, tol, row_pad):
    """q, k, v as views of one fused [B, L, 3, H, D] projection: rows
    3 * H * D elements apart take the 16-byte cp.async copies; with
    ``row_pad`` 2 the rows are 2 elements further apart, no longer whole
    16-byte chunks, and the tiles are loaded element by element."""
    b, l, h, d = 2, 150, 2, 128
    rng = np.random.default_rng(3)
    row = 3 * h * d + row_pad
    flat = torch.from_numpy(rng.normal(size=b * l * row).astype(np.float32))
    flat = flat.to("cuda", dtype)
    q, k, v = (torch.as_strided(flat, (b, l, h, d), (l * row, row, d, 1),
                                i * h * d) for i in range(3))
    do = torch.from_numpy(rng.normal(size=(b, l, h, d)).astype(np.float32))
    do = do.to("cuda", dtype)
    out, lse = tattn.flash_fwd_plain(q, k, v, True, d ** -0.5)
    delta = tattn.attention_delta(do, out)
    got = _bwd_pair(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    # The same values, contiguous: the result must not depend on the path.
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    ref = _bwd_plain(qc, kc, vc, do, lse, delta)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_deterministic(cuda, dtype):
    """No atomics: two launches on the same inputs give dQ, dK and dV
    equal bit for bit (packed segments, causal, several tiles)."""
    q, k, v, do = _inputs(2, 300, 300, 3, 128, dtype, seed=4)
    seg = _segments(2, 300, seed=4)
    out, lse = tattn.flash_fwd_plain(q, k, v, True, 128 ** -0.5,
                                     segment_ids=seg)
    delta = tattn.attention_delta(do, out)
    first = _bwd_pair(q, k, v, do, lse, delta, seg=seg)
    second = _bwd_pair(q, k, v, do, lse, delta, seg=seg)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_kernel_deterministic(cuda, dtype):
    """Two launches of the training forward on the same inputs give O and
    lse equal bit for bit (packed segments, causal, several tiles)."""
    q, k, v, _ = _inputs(2, 300, 300, 3, 128, dtype, seed=6)
    seg = _segments(2, 300, seed=6)
    first, second = (tattn.flash_fwd_cuda(q, k, v, True, 128 ** -0.5,
                                          segment_ids=seg, with_lse=True)
                     for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _large_rows(rng, shape, norm):
    """Rows of norm ``norm`` (logits of std ~norm^2 / sqrt(D) * scale)."""
    x = rng.normal(size=shape).astype(np.float32)
    x *= norm / np.linalg.norm(x, axis=-1, keepdims=True)
    return torch.from_numpy(x).to("cuda")


def _excess(x, r):
    """max |x - r| / (atol + rtol |r|) at 1e-4: at most 1 within bound."""
    return float(((x.float() - r.float()).abs()
                  / (1e-4 + 1e-4 * r.float().abs())).max())


def test_flash_fwd_f32_is_compensated(cuda):
    """The f32 forward runs both products as 3xTF32, not one TF32 pass.
    With rows of q and k of norm 30 (logits of std ~7), O and lse stay
    within 1e-4 of the plain forward in full f32, which the plain forward
    with cuBLAS in TF32 (one pass) misses."""
    b, l, h, d = 2, 256, 2, 128
    rng = np.random.default_rng(7)
    q, k = (_large_rows(rng, (b, l, h, d), 30.0) for _ in range(2))
    v = torch.from_numpy(rng.normal(size=(b, l, h, d))
                         .astype(np.float32)).to("cuda")
    got = tattn.flash_fwd_cuda(q, k, v, True, d ** -0.5, with_lse=True)
    ref = tattn.flash_fwd_plain(q, k, v, True, d ** -0.5)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        one_pass = tattn.flash_fwd_plain(q, k, v, True, d ** -0.5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    kernel = [_excess(x, r) for x, r in zip(got, ref)]
    tf32 = [_excess(x, r) for x, r in zip(one_pass, ref)]
    print(f"3xTF32 kernel / one TF32 pass, error over the 1e-4 bound "
          f"(O, lse): {kernel} / {tf32}")
    assert max(kernel) <= 1.0
    assert tf32[0] > 1.0


def test_flash_bwd_f32_is_compensated(cuda):
    """f32 products run as 3xTF32 (hi.lo + lo.hi + hi.hi), not one TF32
    pass.  Rows of q and k with norm 30 (logits of std ~7) make the
    rounding of a single TF32 pass show: the plain FA2 with cuBLAS in TF32
    misses the 1e-4 bound that the kernels keep against the plain FA2 in
    full f32."""
    b, l, h, d = 2, 256, 2, 128
    rng = np.random.default_rng(5)
    q, k = (_large_rows(rng, (b, l, h, d), 30.0) for _ in range(2))
    v, do = (torch.from_numpy(rng.normal(size=(b, l, h, d))
                              .astype(np.float32)).to("cuda")
             for _ in range(2))
    out, lse = tattn.flash_fwd_plain(q, k, v, True, d ** -0.5)
    delta = tattn.attention_delta(do, out)
    got = _bwd_pair(q, k, v, do, lse, delta)
    ref = _bwd_plain(q, k, v, do, lse, delta)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        one_pass = _bwd_plain(q, k, v, do, lse, delta)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    kernel = [_excess(x, r) for x, r in zip(got, ref)]
    tf32 = [_excess(x, r) for x, r in zip(one_pass, ref)]
    print(f"3xTF32 kernels / one TF32 pass, error over the 1e-4 bound "
          f"(dq, dk, dv): {kernel} / {tf32}")
    assert max(kernel) <= 1.0
    assert min(tf32) > 1.0


@pytest.mark.parametrize("causal,window,segmented", [
    (True, None, False), (True, 70, True), (False, None, False)])
def test_flash_attention_autograd_matches_blockwise(cuda, causal, window,
                                                    segmented):
    """flash_attention on the card under autograd (forward with lse, dQ
    and dK/dV kernels) against autograd through the blockwise tier, f32,
    with a non-contiguous incoming gradient; 1e-4 (summation order)."""
    q, k, v, do = _inputs(2, 190, 190, 2, 128, torch.float32, seed=2)
    seg = _segments(2, 190, seed=2) if segmented else None
    grads = []
    for fn in (tattn.flash_attention, tattn.blockwise_attention):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, causal, window=window, segment_ids=seg)
        g = do.transpose(2, 3).contiguous().transpose(2, 3)  # D not unit
        torch.autograd.backward(out, g)
        grads.append([x.grad for x in leaves] + [out.detach()])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        before = dict(tattn.LAUNCHES)
        tattn.flash_attention(q, k, v, causal, window=window,
                              segment_ids=seg)
    assert tattn.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    assert tattn.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"]


def _cifar_run(cls, device, policy, n_rows, batch, **kw):
    """``cls`` over a numpy-seeded ``cifar_cnn`` on seeded uint8 images:
    (history, Keras-layout weights)."""
    import distkeras_tpu_torch as dkt

    rng = np.random.default_rng(5)
    ds = dkt.Dataset.from_arrays(
        rng.integers(0, 256, (n_rows, 32, 32, 3), dtype=np.uint8),
        rng.integers(0, 10, n_rows))
    t = cls(dkt.zoo.cifar_cnn(seed=2, policy=policy),
            loss="sparse_categorical_crossentropy", batch_size=batch,
            preprocess=lambda x: x.float() / 255, device=device, **kw)
    with pytest.warns(UserWarning, match="preprocess"):
        model = t.train(ds)
    return np.array(t.history), dkt.keras_numpy_from_module(model)[0]


@pytest.mark.parametrize("cls_name,kw", [
    ("SingleTrainer", {}), ("SingleTrainer", {"device_data": True}),
    ("ADAG", {"communication_window": 2})])
def test_cifar_cnn_path_on_card_matches_cpu(cuda, cls_name, kw):
    """float32 (TF32 off): the card's run against the CPU's on the same
    weights and batches.  Losses at rtol 1e-4 / atol 1e-5; weights at
    atol 1e-4: each first-layer kernel gradient sums 64 x 32 x 32
    products of noise pixels, which cuDNN and the CPU add in different
    orders (the first card run read 2.8e-5 after four steps at 0.05)."""
    import distkeras_tpu_torch as dkt

    cls = getattr(dkt, cls_name)
    card = _cifar_run(cls, "cuda", "float32", 256, 64,
                      worker_optimizer="sgd", learning_rate=0.05, **kw)
    host = _cifar_run(cls, "cpu", "float32", 256, 64,
                      worker_optimizer="sgd", learning_rate=0.05, **kw)
    np.testing.assert_allclose(card[0], host[0], rtol=1e-4, atol=1e-5)
    for a, b in zip(card[1], host[1]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_adag_window_one_equals_single_trainer_on_card(cuda):
    """mixed_bfloat16 on the card, deterministic cuDNN: ADAG with a
    window of one is SingleTrainer (the same operations; within 1e-6)."""
    import distkeras_tpu_torch as dkt

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        single = _cifar_run(dkt.SingleTrainer, "cuda", "mixed_bfloat16",
                            512, 128, worker_optimizer="adam")
        adag = _cifar_run(dkt.ADAG, "cuda", "mixed_bfloat16", 512, 128,
                          worker_optimizer="adam", communication_window=1)
    finally:
        torch.backends.cudnn.deterministic = prev
    assert len(single[0]) == len(adag[0]) == 4
    np.testing.assert_allclose(adag[0], single[0], rtol=0, atol=1e-6)
    for a, b in zip(adag[1], single[1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("policy", [None, "dots", "dots_no_batch"])
def test_remat_step_on_card_equals_no_remat(cuda, policy):
    """A remat train step on the card (f32, dropout on, rope + GQA)
    against the same step without remat: the recompute replays the
    forward's kernels and masks, so loss and weights agree within 1e-6;
    the flash forward launches twice a layer (forward and recompute)
    under every policy, the backward kernels once."""
    import dataclasses

    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models.transformer import named_leaves

    cfg = dkt.TransformerConfig(vocab_size=256, d_model=256, n_heads=2,
                                n_kv_heads=1, n_layers=2, d_ff=512,
                                max_len=130, rope=True, dropout=0.1,
                                remat=True, remat_policy=policy)
    tokens = np.random.default_rng(3).integers(0, 256, (2, 129))
    out = []
    for c in (cfg, dataclasses.replace(cfg, remat=False, remat_policy=None)):
        params = dkt.init_params(0, c)
        opt = dkt.Optimizer("adamw", 1e-3)
        step = dkt.make_train_step(c, opt)
        gen = torch.Generator("cuda").manual_seed(4)
        before = dict(tattn.LAUNCHES)
        _, loss = step((params, opt.init(params)), tokens, gen)
        torch.cuda.synchronize()
        went = {k: tattn.LAUNCHES[k] - before[k] for k in before}
        out.append((float(loss), params, went))
    (loss, params, went), (loss0, params0, went0) = out
    assert went == {"flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    assert went0 == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    assert abs(loss - loss0) <= 1e-6
    for (path, a), (_, b) in zip(named_leaves(params),
                                 named_leaves(params0)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6, msg=path)


def test_device_feed_on_card_yields_the_host_batches(cuda):
    """Batches through pinned memory and non-blocking copies, several in
    flight, each different: every one arrives on the card as it left
    the host (a pinned buffer reused before its copy ended would show
    here as a later batch's values)."""
    from distkeras_tpu_torch.data.prefetch import DeviceFeed

    rng = np.random.default_rng(1)
    items = [(rng.normal(size=(64, 1024)).astype(np.float32),
              rng.integers(0, 1000, (64,)).astype(np.int32))
             for _ in range(12)]
    got = []
    for x, y in DeviceFeed(iter(items), depth=3):
        assert x.is_cuda and y.is_cuda
        got.append((x * 1, y + 0))  # device work queued behind each copy
    torch.cuda.synchronize()
    for (x, y), (gx, gy) in zip(items, got):
        np.testing.assert_array_equal(gx.cpu().numpy(), x)
        np.testing.assert_array_equal(gy.cpu().numpy(), y)
