"""The port's CUDA kernels against their plain versions, on the card.

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
    with pytest.raises(NotImplementedError, match="forward-only"):
        x = torch.randn(1, 8, 2, 64, device="cuda", requires_grad=True)
        tattn.flash_attention(x, x, x)
