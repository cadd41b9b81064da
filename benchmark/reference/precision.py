"""The precision the references compute in: full f32 products (TF32
off), unless a control asks for TF32."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32(enabled: bool = False):
    """TF32 products (cuBLAS and cuDNN) on or off inside the block."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep
