"""The port's CUDA kernels against their plain versions, on the card:
the flash forward (inference and training launches), the FA2 dQ and
dK/dV kernels, and ``flash_attention`` under autograd; the Keras
family's CIFAR CNN path on the card against the same path on the CPU;
the serving engines on the card (an f32 schedule against the CPU's,
prefix-pool segments and speculative warm-ups through the kernel); and
the model surface (an MoE train step, ``quantize_params`` and a
``kv_int8`` engine schedule against the CPU's); and resume (an LM run
preempted and resumed by the Supervisor on the card equals the straight
run bit for bit, and its checkpoint restores on the CPU); and the
paper's last workloads (``imdb_lstm`` with both LSTMs and ResNet-50 on
the card against the CPU, Keras' BatchNorm under bf16 autocast); and the
model axis (two gloo ranks sharing the card, each on half the heads:
f32 ``generate`` equal to one process's, and the kernels at the
half-head shapes); and the paged engine (an f32 schedule on the card
equal to the monolithic
engine's and to the CPU's, and a serve phase that allocates no device
memory) and beam search (the card's beams against the CPU's, its
prefill through the forward kernel); and the fleet (the disaggregated
hop equal to a pinned solo engine, and a hot swap that allocates
nothing and moves no weight tensor); and the pipeline axis (two gloo
ranks sharing the card as two stages: losses and weights equal one
process's, the kernel launches the stage layout predicts).

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports no JAX, so on a machine with
the card and without JAX it runs with the suite's conftest switched off:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.ops import attention as tattn

# The kv_int8 engines here run at few lanes by design (their construction
# advisory is tested in tests/test_torch_fleet_contract.py).
pytestmark = [pytest.mark.cuda, pytest.mark.filterwarnings(
    "ignore:kv_int8=True with:RuntimeWarning")]


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


# --------------------------------------------- continuous-batching serving

def _serving_model(device, n_layers=2):
    """An f32 serving config whose head_dim (64) the forward kernel
    takes, with numpy-seeded weights on ``device``."""
    from distkeras_tpu_torch.models.transformer import TransformerConfig
    from distkeras_tpu_torch.utils.serialization import params_from_numpy

    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=2,
                            n_layers=n_layers, d_ff=256, max_len=96,
                            rope=True)
    rng = np.random.default_rng(3)
    dense = lambda *s: (rng.standard_normal(s, dtype=np.float32)
                        / np.float32(s[-2] if len(s) > 1 else 1) ** 0.5)
    L, d, h, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim
    np_params = {
        "tok_emb": dense(cfg.vocab_size, d),
        "ln_f_scale": np.ones(d, np.float32),
        "layers": {
            "ln1_scale": np.ones((L, d), np.float32),
            "ln2_scale": np.ones((L, d), np.float32),
            "attn": {"wq": dense(L, d, h, hd), "wk": dense(L, d, h, hd),
                     "wv": dense(L, d, h, hd), "wo": dense(L, h, hd, d)},
            "ffn": {"w1": dense(L, d, cfg.d_ff), "w2": dense(L, cfg.d_ff, d)},
        }}
    return cfg, np_params, params_from_numpy(np_params, device)


def _schedule(cfg, params, device):
    """Staggered admissions over 4 lanes, a 1-token prompt, a lane reused
    after a longer occupant, a sampled request; every request's tokens."""
    from distkeras_tpu_torch.serving import ContinuousBatcher

    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 7, 1, 11, 4)]
    eng = ContinuousBatcher(params, cfg, lanes=4, temperature=0.9,
                            per_request_sampling=True, device=device)
    a = eng.submit(prompts[0], 40, temperature=0.0)
    eng.step(4)
    b = eng.submit(prompts[1], 30, temperature=0.0)
    c = eng.submit(prompts[2], 24, seed=5)
    eng.step(2)
    d = eng.submit(prompts[3], 16, temperature=0.0)
    outs = {}
    for name, lane in zip("abcd", (a, b, c, d)):
        while lane in eng.running():
            eng.step(3)
        outs[name] = eng.drain(lane)
    e = eng.submit(prompts[4], 12, temperature=0.0)   # lane a, reused
    while e in eng.running():
        eng.step(1)
    outs["e"] = eng.drain(e)
    return outs


def test_engine_schedule_on_card_matches_cpu(cuda):
    """An f32 engine schedule gives the same greedy tokens on the card as
    on the CPU.  CUDA and CPU generators draw different uniforms, so the
    sampled lane is held to its own solo generate(seed=) on each device."""
    from distkeras_tpu_torch.models.generate import generate

    cfg, _, card_p = _serving_model("cuda")
    _, _, cpu_p = _serving_model("cpu")
    card, cpu = _schedule(cfg, card_p, "cuda"), _schedule(cfg, cpu_p, "cpu")
    for name in "abde":
        np.testing.assert_array_equal(card[name], cpu[name])
    for outs, p, dev in ((card, card_p, "cuda"), (cpu, cpu_p, "cpu")):
        solo = generate(p, outs["c"][None, :1], cfg, 24, temperature=0.9,
                        seed=5, device=dev)[0].cpu().numpy()
        np.testing.assert_array_equal(outs["c"], solo)


def test_prefix_pool_segment_on_card_launches_the_forward_kernel(cuda):
    """A PrefixPool segment built by prefill on the card launches the
    forward kernel once a layer; a pooled request equals
    generate(tail, prompt_cache=(segment, P)) and greedy
    speculative_generate (its warm prefills launch the kernel too)
    equals generate."""
    from distkeras_tpu_torch.models.generate import generate, prefill
    from distkeras_tpu_torch.models.speculative import speculative_generate
    from distkeras_tpu_torch.serving import ContinuousBatcher, PrefixPool

    cfg, _, params = _serving_model("cuda")
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, cfg.vocab_size, 40)
    before = tattn.LAUNCHES["flash_fwd"]
    seg, _ = prefill(params, prefix[None], cfg, last_logits=False)
    assert tattn.LAUNCHES["flash_fwd"] == before + cfg.n_layers
    pool = PrefixPool(cfg, slots=2)
    pid = pool.put(seg, 40)
    eng = ContinuousBatcher(params, cfg, lanes=2, prefix_pool=pool)
    tail = rng.integers(0, cfg.vocab_size, 9)
    lane = eng.submit(tail, 20, prefix_id=pid)
    while lane in eng.running():
        eng.step(4)
    ref = generate(params, tail[None], cfg, 20, prompt_cache=(seg, 40))
    np.testing.assert_array_equal(eng.drain(lane), ref[0].cpu().numpy())
    prompts = rng.integers(0, cfg.vocab_size, (3, 12))
    before = tattn.LAUNCHES["flash_fwd"]
    out, stats = speculative_generate(params, params, prompts, cfg, cfg, 16,
                                      n_draft=3)
    assert tattn.LAUNCHES["flash_fwd"] == before + 2 * cfg.n_layers
    assert float(stats["acceptance_rate"]) == 1.0
    torch.testing.assert_close(out, generate(params, prompts, cfg, 16),
                               rtol=0, atol=0)


# ------------------------------------------------ MoE, int8, the int8 cache

def test_moe_train_step_on_card_matches_cpu(cuda):
    """An f32 top-2 MoE lm_loss on the card (flash kernels, index
    dispatch) against the CPU (plain attention): the loss within 1e-5
    and every leaf's gradient within 1e-3 * max|g| (the card's gradient
    bound); the kernels launch once a layer each."""
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models.transformer import named_leaves

    cfg = dkt.TransformerConfig(vocab_size=256, d_model=128, n_heads=2,
                                n_layers=2, d_ff=256, max_len=130,
                                num_experts=4, moe_top_k=2,
                                capacity_factor=1.0)
    tokens = np.random.default_rng(5).integers(0, 256, (2, 129))
    host = dkt.init_params(0, cfg, device="cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        params = dkt.params_from_numpy(dkt.params_to_numpy(host), dev)
        for _, leaf in named_leaves(params):
            leaf.requires_grad_()
        before = dict(tattn.LAUNCHES)
        loss = dkt.lm_loss(params, tokens, cfg)
        loss.backward()
        went = {k: tattn.LAUNCHES[k] - before[k] for k in before}
        out[dev] = (float(loss.detach()), {n: t.grad.cpu() for n, t in
                                  named_leaves(params)}, went)
    assert out["cuda"][2] == {"flash_fwd": 2, "flash_bwd_dq": 2,
                              "flash_bwd_dkv": 2}
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5
    for name, g in out["cpu"][1].items():
        err = (out["cuda"][1][name] - g).abs().max()
        assert err <= 1e-3 * g.abs().max(), name


def test_quantize_params_on_card_is_bit_identical_to_cpu(cuda):
    from distkeras_tpu_torch.models.quant import quantize_kv, quantize_params

    _, _, cpu_p = _serving_model("cpu")
    _, _, card_p = _serving_model("cuda")
    cpu_q, card_q = quantize_params(cpu_p), quantize_params(card_p)
    pairs = [(card_q["tok_emb"], cpu_q["tok_emb"])]
    for group in ("attn", "ffn"):
        pairs += [(card_q["layers"][group][k], v)
                  for k, v in cpu_q["layers"][group].items()]
    for got, want in pairs:
        assert torch.equal(got.q.cpu(), want.q)
        assert torch.equal(got.s.cpu(), want.s)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 9, 2, 64)).astype(np.float32))
    for got, want in zip(quantize_kv(x.cuda()), quantize_kv(x)):
        assert torch.equal(got.cpu(), want)


def test_kv_int8_engine_schedule_on_card_matches_cpu(cuda):
    """An f32 greedy kv_int8 engine schedule (staggered admissions, a
    1-token prompt, a reused lane) gives the same tokens on the card as
    on the CPU, and on the card each request equals its solo
    generate(kv_int8=True, use_prefill=False)."""
    from distkeras_tpu_torch.models.generate import generate
    from distkeras_tpu_torch.serving import ContinuousBatcher

    cfg, _, card_p = _serving_model("cuda")
    _, _, cpu_p = _serving_model("cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 1, 11, 6)]
    outs = {}
    for dev, params in (("cuda", card_p), ("cpu", cpu_p)):
        eng = ContinuousBatcher(params, cfg, lanes=2, kv_int8=True,
                                device=dev)
        lanes = [eng.submit(prompts[0], 30), eng.submit(prompts[1], 20)]
        got = []
        for i, p in enumerate(prompts[2:]):
            while lanes[i] in eng.running():
                eng.step(3)
            got.append(eng.drain(lanes[i]))
            lanes.append(eng.submit(p, 16))   # a reused lane
        for lane in lanes[2:]:
            while lane in eng.running():
                eng.step(2)
            got.append(eng.drain(lane))
        outs[dev] = got
    for a, b in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_array_equal(a, b)
    for p, got in zip(prompts, outs["cuda"]):
        solo = generate(card_p, p[None], cfg, len(got) - len(p),
                        kv_int8=True, use_prefill=False)
        np.testing.assert_array_equal(got, solo[0].cpu().numpy())


def _paged_schedule(cfg, params, device, paged=True, **kw):
    """Staggered admissions with a shared stem, a chunked long prompt, a
    fork and a reused lane over 3 lanes; every request's tokens."""
    from distkeras_tpu_torch.serving import ContinuousBatcher, PagedBatcher

    rng = np.random.default_rng(11)
    stem = rng.integers(0, cfg.vocab_size, 32)
    prompts = [np.concatenate([stem, rng.integers(0, cfg.vocab_size, n)])
               for n in (5, 9)] + [rng.integers(0, cfg.vocab_size, n)
                                   for n in (50, 7)]
    if paged:
        eng = PagedBatcher(params, cfg, lanes=3, block=16,
                           prefill_chunk=32, device=device, **kw)
    else:
        eng = ContinuousBatcher(params, cfg, lanes=3, prefill_chunk=32,
                                device=device, **kw)
    outs = {}
    a = eng.submit(prompts[0], 30)
    eng.step(4)
    b = eng.submit(prompts[1], 24)
    c = eng.submit(prompts[2], 20)       # parks: two chunks
    for name, lane in zip("abc", (a, b, c)):
        while lane in eng.running():
            eng.step(3)
        outs[name] = eng.drain(lane)
    d = eng.submit(prompts[3], 12)       # a reused lane
    while d in eng.running():
        eng.step(1)
    outs["d"] = eng.drain(d)
    if paged:
        assert eng.stem_hit_blocks == 2
        assert eng.allocator.stats()["used"] == 0
    return outs


def test_paged_schedule_on_card_matches_monolithic_and_cpu(cuda):
    """An f32 paged schedule on the card: the monolithic engine's tokens
    on the card, and the paged engine's on the CPU."""
    cfg, _, card_p = _serving_model("cuda")
    _, _, cpu_p = _serving_model("cpu")
    paged = _paged_schedule(cfg, card_p, "cuda")
    mono = _paged_schedule(cfg, card_p, "cuda", paged=False)
    cpu = _paged_schedule(cfg, cpu_p, "cpu")
    for name in paged:
        np.testing.assert_array_equal(paged[name], mono[name])
        np.testing.assert_array_equal(paged[name], cpu[name])


def test_paged_kv_int8_prefill_admission_launches_the_kernel(cuda):
    """kv_int8="prefill": a from-scratch admission runs prefill (one
    forward launch a layer), and the first token it serves is the
    decode-built engine's (the two int8 caches differ by rounding: later
    tokens of this random-weight model may part at near ties)."""
    from distkeras_tpu_torch.serving import PagedBatcher

    cfg, _, params = _serving_model("cuda")
    p = np.random.default_rng(2).integers(0, cfg.vocab_size, 40)
    outs = {}
    for mode in (True, "prefill"):
        eng = PagedBatcher(params, cfg, lanes=1, block=16, kv_int8=mode)
        before = tattn.LAUNCHES["flash_fwd"]
        lane = eng.submit(p, 16)
        launched = tattn.LAUNCHES["flash_fwd"] - before
        assert launched == (cfg.n_layers if mode == "prefill" else 0)
        while lane in eng.running():
            eng.step(4)
        outs[mode] = eng.drain(lane)
    assert outs[True][len(p)] == outs["prefill"][len(p)]


def test_paged_serve_phase_allocates_nothing(cuda):
    """The counterpart of the reference's zero serve-phase compiles: once
    warm, step(4) windows over busy lanes leave the allocator's reserved
    bytes and its device-allocation count unchanged, for the paged and
    the monolithic engine."""
    from distkeras_tpu_torch.serving import ContinuousBatcher, PagedBatcher

    cfg, _, params = _serving_model("cuda")
    rng = np.random.default_rng(5)
    for cls, kw in ((PagedBatcher, dict(block=16)), (ContinuousBatcher, {})):
        eng = cls(params, cfg, lanes=4, device="cuda", **kw)
        for p in rng.integers(0, cfg.vocab_size, (4, 12)):
            eng.submit(p, 60)
        eng.step(4)
        eng.step(4)
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        allocs = torch.cuda.memory_stats()["num_device_alloc"]
        for _ in range(8):
            eng.step(4)
        torch.cuda.synchronize()
        assert torch.cuda.memory_reserved() == reserved, cls.__name__
        assert (torch.cuda.memory_stats()["num_device_alloc"]
                == allocs), cls.__name__


def test_beam_search_on_card_matches_cpu(cuda):
    """f32 beams on the card equal the CPU's (sequences exact, scores to
    1e-5) on both impls; the prompt pass launches the forward kernel once
    a layer, and width 1 is greedy generate."""
    from distkeras_tpu_torch.models.generate import beam_search, generate

    cfg, _, card_p = _serving_model("cuda")
    _, _, cpu_p = _serving_model("cpu")
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 20))
    for impl in ("ancestry", "physical"):
        before = tattn.LAUNCHES["flash_fwd"]
        s, sc = beam_search(card_p, prompt, cfg, 24, beam_width=3,
                            eos_token=3, beam_impl=impl)
        assert tattn.LAUNCHES["flash_fwd"] - before == cfg.n_layers
        cs, csc = beam_search(cpu_p, prompt, cfg, 24, beam_width=3,
                              eos_token=3, beam_impl=impl, device="cpu")
        np.testing.assert_array_equal(s.cpu().numpy(), cs.numpy())
        np.testing.assert_allclose(sc.cpu().numpy(), csc.numpy(),
                                   atol=1e-5, rtol=1e-5)
    s1, _ = beam_search(card_p, prompt, cfg, 16, beam_width=1)
    g = generate(card_p, prompt, cfg, 16)
    np.testing.assert_array_equal(s1[:, 0].cpu().numpy(), g.cpu().numpy())


def test_lm_zero1_in_a_world1_nccl_group_equals_zero_none(cuda, tmp_path):
    """The data-parallel LM on the card in a world-1 NCCL group: zero=1
    (reduce-scatter, shard update, all-gather through NCCL) gives the
    plain exchange's losses and weights (elementwise update math)."""
    import torch.distributed as dist

    import distkeras_tpu_torch as dkt

    cfg = dkt.TransformerConfig(vocab_size=64, d_model=128, n_heads=2,
                                n_layers=2, d_ff=256, max_len=17)
    tokens = np.random.default_rng(3).integers(0, 64, (8, 17)).astype(
        np.int32)
    np_params = dkt.params_to_numpy(dkt.init_params(0, cfg, device="cpu"))
    dkt.initialize_multihost(init_method=f"file://{tmp_path}/rdv",
                             world_size=1, rank=0, timeout=60)
    try:
        assert dist.get_backend() == "nccl"
        runs = []
        for kw in ({}, dict(zero=1), dict(zero=3)):
            t = dkt.LMTrainer(cfg, batch_size=4, **kw)
            out = t.train(tokens, params=dkt.params_from_numpy(np_params,
                                                               "cuda"))
            runs.append((t.history, dkt.params_to_numpy(out)))
    finally:
        dist.destroy_process_group()
    (h0, p0) = runs[0]
    for h, p in runs[1:]:
        np.testing.assert_allclose(h, h0, rtol=1e-6)
        for k in p0:
            if isinstance(p0[k], dict):
                continue
            np.testing.assert_allclose(p[k], p0[k], rtol=1e-6, atol=1e-7)


def test_two_rank_gloo_adag_on_card_equals_world1(cuda, tmp_path):
    """Two ranks sharing the card over gloo (CUDA tensors), started by
    deploy.Job: ADAG(num_workers=2) equals world-1 ADAG at twice the
    batch on the same rows (Keras tolerance)."""
    # tests/ is on the path (pytest's rootdir-relative import), as the
    # suite's conftest imports helpers.
    from helpers import make_blobs
    from torch_dp_ranks import spawn

    import distkeras_tpu_torch as dkt

    x, y = make_blobs(n=256)
    model = dkt.zoo.MLP(16, (32,), 4, seed=0)
    weights = dkt.keras_numpy_from_module(model)[0]
    data = dict(x=x, y=y, n_w=np.asarray(len(weights)),
                **{f"w{i}": w for i, w in enumerate(weights)})
    kw = dict(batch_size=8, communication_window=2, worker_optimizer="adam",
              learning_rate=0.01)
    got = spawn(tmp_path, 2, [dict(name="adag", kind="keras",
                                   trainer="ADAG", kw=kw)], data,
                device="cuda:0", backend="gloo")["adag"][0]
    t = dkt.ADAG(model, loss="sparse_categorical_crossentropy",
                 **dict(kw, batch_size=16))
    out = t.train(dkt.Dataset.from_arrays(x, y))
    np.testing.assert_allclose(got["history"], t.history, rtol=1e-4,
                               atol=1e-5)
    for i, w in enumerate(dkt.keras_numpy_from_module(out)[0]):
        np.testing.assert_allclose(got[f"m0_w{i}"], w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("backend", ["pickle", "orbax"])
def test_lm_resume_on_card_equals_straight_run(cuda, tmp_path, backend):
    """LMTrainer with dropout on the card: a run preempted at round 3 and
    resumed by the Supervisor from round 2 ends bit-identical to the
    straight run (the kernels are deterministic and the CUDA dropout
    generator's state rides the checkpoint), through all three kernels;
    and the checkpoint it wrote restores on the CPU — under both
    checkpoint backends."""
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models.transformer import named_leaves

    cfg = dkt.TransformerConfig(vocab_size=128, d_model=256, n_heads=2,
                                n_layers=2, d_ff=512, max_len=129,
                                dropout=0.1)
    rows = np.random.default_rng(0).integers(0, 128, (24, 129)).astype(
        np.int32)
    kw = dict(optimizer="adamw", learning_rate=3e-4, batch_size=4, seed=1)
    straight = dkt.LMTrainer(cfg, **kw)
    ref = straight.train(rows)
    d = str(tmp_path / "c")
    t = dkt.LMTrainer(cfg, checkpoint_dir=d, checkpoint_every=2,
                      max_checkpoints=10, checkpoint_backend=backend, **kw)
    sup = dkt.Supervisor(t, max_retries=0, handle_sigterm=False)
    before = dict(tattn.LAUNCHES)
    with dkt.FaultPlan().preempt("train.round", at=3):
        out = sup.run(rows)
    torch.cuda.synchronize()
    assert [a.resumed_from for a in sup.attempts] == [None, 2]
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert tattn.LAUNCHES[k] - before[k] == 7 * cfg.n_layers, k
    assert t.history == straight.history[2:]
    for (n, a), (_, b) in zip(named_leaves(out), named_leaves(ref)):
        assert torch.equal(a, b), n
    # Written on the card, read on the CPU: the round-6 parameters.
    tree = dkt.CheckpointManager(d).restore()
    for n, a in named_leaves(ref):
        assert torch.equal(dict(named_leaves(tree["params"]))[n],
                           a.detach().cpu()), n
    assert tree["dropout"].shape[0] == 1 and tree["opt"]["count"] == 6


@pytest.mark.parametrize("fused", [True, False])
def test_imdb_lstm_on_card_matches_cpu(cuda, fused):
    """f32 ``imdb_lstm`` (FusedLSTM, or the stock LSTM on cuDNN's fused
    kernel), 4 sgd steps on the card against the CPU on the same weights
    and batches: losses and Keras weights at rtol 1e-4 / atol 1e-5."""
    import distkeras_tpu_torch as dkt

    rng = np.random.default_rng(7)
    x = rng.integers(0, 300, (128, 20)).astype(np.int32)
    y = (x[:, 0] < 150).astype(np.int64)
    out = []
    for device in ("cuda", "cpu"):
        t = dkt.SingleTrainer(
            dkt.zoo.imdb_lstm(vocab_size=300, embed_dim=16, lstm_units=16,
                              maxlen=20, seed=1, fused=fused),
            loss="binary_crossentropy", worker_optimizer="sgd",
            learning_rate=0.1, batch_size=32, device=device)
        m = t.train(dkt.Dataset.from_arrays(x, y))
        out.append((np.array(t.history), dkt.get_weights(m)))
    (h_card, w_card), (h_cpu, w_cpu) = out
    assert len(h_card) == 4
    np.testing.assert_allclose(h_card, h_cpu, rtol=1e-4, atol=1e-5)
    for a, b in zip(w_card, w_cpu):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_resnet50_on_card_matches_cpu(cuda):
    """f32 ResNet-50 at 64 x 64, batch 4, on the card against the CPU:
    inference logits at 1e-4 of max |logit|, training-mode logits (batch
    statistics) at 5e-4 of it (tests/test_torch_resnet.py's bounds), the
    moving statistics after the training-mode pass at rtol 1e-4 / atol
    1e-5, one sgd step's loss at rtol 1e-4, and one float64 sgd step's
    weights at rtol 1e-6 / atol 1e-8 (f32 updates of this random-init
    net are ill-conditioned; tests/test_torch_resnet.py holds the float64
    step to the reference's)."""
    import distkeras_tpu_torch as dkt

    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (4, 64, 64, 3)).astype(np.float32))
    mods = {d: dkt.zoo.resnet50(num_classes=10, input_shape=(64, 64, 3),
                                seed=4).to(d) for d in ("cuda", "cpu")}
    for training, tol in ((False, 1e-4), (True, 5e-4)):
        with torch.no_grad():
            got = {d: m.train(training)(x.to(d)).cpu()
                   for d, m in mods.items()}
        scale = float(got["cpu"].abs().max())
        torch.testing.assert_close(got["cuda"], got["cpu"], rtol=0,
                                   atol=tol * scale)
    for a, b in zip(mods["cuda"].buffers(), mods["cpu"].buffers()):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        for d in ("cuda", "cpu"):
            t = dkt.SingleTrainer(
                dkt.zoo.resnet50(num_classes=10, input_shape=(64, 64, 3),
                                 seed=4).to(dtype),
                loss="sparse_categorical_crossentropy",
                worker_optimizer="sgd", learning_rate=0.01, batch_size=4,
                device=d)
            xs = x.numpy().astype(
                np.float64 if dtype == torch.float64 else np.float32)
            out = t.train(dkt.Dataset.from_arrays(xs, np.arange(4)))
            runs[dtype, d] = (t.history, dkt.get_weights(out))
    np.testing.assert_allclose(runs[torch.float32, "cuda"][0],
                               runs[torch.float32, "cpu"][0], rtol=1e-4)
    for a, b in zip(runs[torch.float64, "cuda"][1],
                    runs[torch.float64, "cpu"][1]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)


def test_keras_batchnorm_under_bf16_autocast_on_card(cuda):
    """Keras' BN under the zoo's mixed_bfloat16 on the card: a bf16 input
    (a bf16 conv's output) gives a bf16 output computed in f32 (within
    one bf16 rounding of the f32 result on the same values), f32
    parameters and moving statistics, the statistics those of the bf16
    values in f32 (biased variance, momentum 0.99)."""
    from distkeras_tpu_torch.models.batchnorm import KerasBatchNorm

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(3.0, 2.0, (8, 16, 6, 6)).astype(
        np.float32)).cuda().to(memory_format=torch.channels_last)
    xb = x.to(torch.bfloat16)
    bn = KerasBatchNorm(16, axis=1, epsilon=1.001e-5).cuda().train()
    with torch.no_grad():
        bn.gamma.copy_(torch.linspace(0.5, 1.5, 16))
        bn.beta.copy_(torch.linspace(-1, 1, 16))
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = bn(xb)
    assert out.dtype == torch.bfloat16
    assert bn.gamma.dtype == bn.moving_mean.dtype == torch.float32
    xf = xb.float()
    var, mean = torch.var_mean(xf, (0, 2, 3), correction=0)
    want = ((xf - mean[:, None, None]) * torch.rsqrt(var + 1.001e-5)[
        :, None, None] * bn.gamma[:, None, None] + bn.beta[:, None, None])
    torch.testing.assert_close(out.float(), want.detach(), rtol=1e-2,
                               atol=1e-2)
    torch.testing.assert_close(bn.moving_mean, 0.01 * mean, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(bn.moving_variance, 0.99 + 0.01 * var,
                               rtol=1e-5, atol=1e-6)


def test_disagg_on_card_equals_pinned_solo(cuda):
    """The disaggregated hop on the card (f32, 2 layers): a
    role="prefill" PagedBatcher(kv_int8="prefill") exports each cold stem
    through the forward kernel (one launch a layer), the blocks cross the
    wire codec into a role="decode" one, and every request's tokens equal
    one engine that pins the same stems first; a warm stem ships
    nothing, and no block stays in use after shutdown."""
    import warnings

    from distkeras_tpu_torch.serving import (InProcessReplica, PagedBatcher,
                                             Router, decode_shipment,
                                             encode_shipment)

    class Wire(InProcessReplica):
        def import_blocks(self, shipment):
            return self.engine.import_blocks(
                decode_shipment(encode_shipment(shipment)))

    cfg, _, params = _serving_model("cuda")
    rng = np.random.default_rng(11)
    stems = rng.integers(0, cfg.vocab_size, (2, 32))
    prompts = [np.concatenate([stems[i % 2], rng.integers(
        0, cfg.vocab_size, 5)]) for i in range(4)]

    def engine():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            return PagedBatcher(params, cfg, lanes=2, block=16,
                                kv_int8="prefill", max_queue=8)

    def serve(submit, step, poll, ps):
        rids = [submit(p) for p in ps]
        while any(poll(r) is None for r in rids):
            step()
        return [np.asarray(poll(r).tokens) for r in rids]

    solo = engine()
    before = tattn.LAUNCHES["flash_fwd"]
    for s in stems:
        solo.pin_prefix(s)
    assert tattn.LAUNCHES["flash_fwd"] - before == 2 * cfg.n_layers
    want = serve(lambda p: solo.enqueue(p, 12), solo.step, solo.poll,
                 prompts)
    pre, dec = engine(), engine()
    router = Router([InProcessReplica("pre", pre, role="prefill"),
                     Wire("dec", dec, role="decode")])
    router.refresh_residency()
    before = tattn.LAUNCHES["flash_fwd"]
    got = serve(lambda p: router.enqueue(p, 12), router.step, router.poll,
                prompts)
    assert tattn.LAUNCHES["flash_fwd"] - before == 2 * cfg.n_layers
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert dec.stem_hit_blocks == 4 * 2
    router.shutdown()
    assert pre.allocator.stats()["used"] == dec.allocator.stats()["used"] \
        == 0


def test_hot_swap_allocates_nothing_and_keeps_every_pointer(cuda):
    """``swap_params`` on the card copies into the live weight tensors:
    the allocator's reserved bytes and device allocations and every
    leaf's ``data_ptr()`` are unchanged, the engine then serves the new
    version's tokens (a fresh engine's on those weights), and a refused
    swap leaves the weights bit for bit."""
    from distkeras_tpu_torch.models.transformer import named_leaves
    from distkeras_tpu_torch.serving import ContinuousBatcher

    cfg, _, params = _serving_model("cuda")
    new = {k: v for k, v in _serving_model("cuda")[2].items()}
    new["tok_emb"] = new["tok_emb"].flip(0).contiguous()
    prompts = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 9))

    def serve(eng):
        lanes = [eng.submit(p, 10) for p in prompts]
        while eng.running():
            eng.step()
        return [eng.drain(la) for la in lanes]

    eng = ContinuousBatcher(params, cfg, lanes=2, hot_swap=True)
    serve(eng)
    torch.cuda.synchronize()
    ptrs = [t.data_ptr() for _, t in named_leaves(eng.params)]
    mem = (torch.cuda.memory_reserved(),
           torch.cuda.memory_stats()["num_device_alloc"])
    eng.swap_params(new, 1)
    torch.cuda.synchronize()
    assert [t.data_ptr() for _, t in named_leaves(eng.params)] == ptrs
    assert (torch.cuda.memory_reserved(),
            torch.cuda.memory_stats()["num_device_alloc"]) == mem
    fresh = ContinuousBatcher(new, cfg, lanes=2)
    for a, b in zip(serve(eng), serve(fresh)):
        np.testing.assert_array_equal(a, b)
    keep = [t.clone() for _, t in named_leaves(eng.params)]
    bad = dict(new, ln_f_scale=new["ln_f_scale"].double())
    with pytest.raises(ValueError, match="leaf"):
        eng.swap_params(bad, 2)
    assert all(torch.equal(a, b) for a, (_, b) in
               zip(keep, named_leaves(eng.params)))
    assert eng.param_version == 1


@pytest.mark.parametrize("heads,dtype,tol", [(4, torch.bfloat16, 2e-2),
                                             (2, torch.bfloat16, 2e-2),
                                             (4, torch.float32, 1e-4)])
def test_kernels_at_half_head_shapes_match_plain(cuda, heads, dtype, tol):
    """A rank of the model axis runs the kernels on its own heads: the
    forward with lse and the dQ / dK/dV pair at H = 4 and 2 (and the
    grouped-query heads expanded before the kernel) against the plain
    versions."""
    gen = torch.Generator(device="cuda").manual_seed(heads)
    q, k, v, do = (torch.randn((2, 192, heads, 128), generator=gen,
                               device="cuda", dtype=dtype)
                   for _ in range(4))
    kv = k[:, :, :1].repeat_interleave(heads, dim=2)  # GQA: one kv head
    scale = 128 ** -0.5
    with torch.no_grad():
        for kk in (k, kv):
            out, lse = tattn.flash_fwd_cuda(q, kk, v, True, scale, None,
                                            None, with_lse=True)
            ref, ref_lse = tattn.flash_fwd_plain(q, kk, v, True, scale, None,
                                                 None)
            delta = tattn.attention_delta(do, ref)
            dq = tattn.flash_bwd_dq_cuda(q, kk, v, do, ref_lse, delta, True,
                                         scale, None, None)
            dk, dv = tattn.flash_bwd_dkv_cuda(q, kk, v, do, ref_lse, delta,
                                              True, scale, None, None)
            rdq = tattn.flash_bwd_dq_plain(q, kk, v, do, ref_lse, delta, True,
                                           scale, None, None)
            rdk, rdv = tattn.flash_bwd_dkv_plain(q, kk, v, do, ref_lse, delta,
                                                 True, scale, None, None)
            for got, want in ((out, ref), (lse, ref_lse), (dq, rdq),
                              (dk, rdk), (dv, rdv)):
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=tol, rtol=tol)


def test_tp_generate_on_card_equals_one_process(cuda, tmp_path):
    """Two gloo ranks sharing the card, model axis 2 under
    ``serving_plan()``: f32 greedy ``generate`` equal to one process's
    on the card, the logits within 1e-5 of max |logit|, every rank
    picking the same tokens and launching the forward kernel on its
    heads."""
    from torch_dp_ranks import spawn

    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models import transformer as tfm

    cfg = dict(vocab_size=256, d_model=512, n_heads=4, n_layers=2,
               d_ff=1024, max_len=128, rope=True)
    tcfg = tfm.TransformerConfig(**cfg)
    params = dkt.params_to_numpy(tfm.init_params(0, tcfg, device="cpu"))
    prompts = np.random.default_rng(3).integers(0, 256, (2, 40))
    flat = {f"p/{k}": v for k, v in tfm.named_leaves(params)}
    got = spawn(tmp_path, 2, [dict(name="gen", kind="tp", fn="generate_case",
                                   mesh=dict(data=1, model=2),
                                   plan="serving", new=16)],
                dict(prompts=prompts, **flat), cfg=cfg, device="cuda:0",
                backend="gloo")["gen"]
    solo = dkt.params_from_numpy(params, "cuda")
    want = dkt.generate(solo, prompts, tcfg, 16).cpu().numpy()
    logits = dkt.apply(solo, prompts, tcfg)[0].cpu().numpy()
    for r in got:
        assert bool(r["picks_agree"]) and int(r["fwd_launches"]) >= 2
        np.testing.assert_array_equal(r["generate"], want)
        np.testing.assert_allclose(r["logits"], logits, rtol=0,
                                   atol=1e-5 * np.abs(logits).max())


def test_pipeline_train_on_card_equals_one_process(cuda, tmp_path):
    """Two gloo ranks sharing the card, pipeline axis 2 with 4
    microbatches (phase axes (b) at a small width): the losses and the
    trained weights equal one process's on the card, and each stage
    launches the kernels its layout predicts (2 layers x 4 microbatches
    of the forward with lse, and of each backward, a step)."""
    from torch_dp_ranks import spawn

    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models import transformer as tfm

    cfg = dict(vocab_size=256, d_model=256, n_heads=2, n_layers=4,
               d_ff=512, max_len=128, dtype="float32")
    tcfg = tfm.TransformerConfig(**cfg)
    params = dkt.params_to_numpy(tfm.init_params(0, tcfg, device="cpu"))
    tokens = np.random.default_rng(3).integers(0, 256, (16, 129))
    kw = dict(batch_size=8, optimizer="adamw", learning_rate=3e-4)
    flat = {f"p/{k}": v for k, v in tfm.named_leaves(params)}
    got = spawn(tmp_path, 2, [dict(name="pp", kind="axes", fn="train_case",
                                   mesh=dict(data=1, pipeline=2),
                                   kw=dict(kw, microbatches=4))],
                dict(tokens=tokens, **flat), cfg=cfg, device="cuda:0",
                backend="gloo")["pp"]
    solo = dkt.LMTrainer(tcfg, **kw)
    want = dict(tfm.named_leaves(dkt.params_to_numpy(solo.train(
        tokens, params=dkt.params_from_numpy(params, "cuda")))))
    for r in got:
        np.testing.assert_allclose(r["history"], solo.history, rtol=1e-4)
        for k, v in want.items():
            np.testing.assert_allclose(r["p/" + k], v, rtol=1e-4,
                                       atol=1e-4, err_msg=k)
        assert r["launches"].tolist() == [2 * 4 * 2] * 3


def test_device_span_reads_what_a_bare_event_pair_reads(cuda, tmp_path):
    """``obs.device_span`` around known kernels: its ``dev_dur`` is the
    device time a bare CUDA-event pair around the same span reads."""
    from distkeras_tpu_torch import obs

    a = torch.randn(4096, 4096, device="cuda")
    for _ in range(3):
        a @ a
    torch.cuda.synchronize()
    path = str(tmp_path / "t.jsonl")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with obs.session(trace_path=path):
        start.record()
        with obs.device_span("x"):
            for _ in range(20):
                a @ a
        end.record()
    (rec,) = [r for r in obs.read_trace(path) if r.get("name") == "x"]
    bare = start.elapsed_time(end) / 1e3
    assert rec["dev_dur"] == pytest.approx(bare, rel=0.02)


def test_span_on_a_device_capture_covers_a_host_sleep(cuda, tmp_path):
    """In a capture of device activity only, an ``obs.span`` around a 5
    ms host sleep between two kernels, put on the capture's timeline
    through the trace's clock anchor (``obs.span_unix_ns``), lies
    between the kernels and covers at least 4 ms in which the card runs
    nothing."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distkeras_tpu_torch import obs

    a = torch.randn(2048, 2048, device="cuda")
    a @ a
    torch.cuda.synchronize()
    path = str(tmp_path / "t.jsonl")
    with obs.session(trace_path=path) as sess:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        a @ a
        torch.cuda.synchronize()
        with obs.span("host.sleep"):
            time.sleep(0.005)
        a @ a
        torch.cuda.synchronize()
        prof.stop()
        clock = sess.trace.clock
    busy = sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)
    (rec,) = [r for r in obs.read_trace(path)
              if r.get("name") == "host.sleep"]
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    s, e = ((t - start_ns) / 1e3 for t in obs.span_unix_ns(rec, clock))
    before = max(be for bs, be in busy if bs < s)
    after = min(bs for bs, be in busy if bs > s)
    assert before - 200 <= s and e <= after + 200
    s, e = max(s, busy[0][0]), min(e, busy[-1][1])
    idle = e - s - sum(max(0.0, min(be, e) - max(bs, s)) for bs, be in busy)
    assert idle >= 4000
