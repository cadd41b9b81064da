"""distkeras_tpu_torch: the PyTorch / CUDA (Hopper) port of distkeras_tpu.

A second package beside the JAX one, which stays the reference.  This
slice serves the decoder-only transformer LM: ``generate`` runs a
batched prefill through the hand-written flash-attention forward kernel
(``ops/csrc/flash_fwd.cu``), then a KV-cached decode loop.

Device rule: entry points run on CUDA by default; with no card they
raise unless called with ``device="cpu"`` (as the tests do).  The port
imports ``torch`` and numpy, never ``jax`` or ``distkeras_tpu``.
"""

from distkeras_tpu_torch.models.generate import (
    generate,
    init_cache,
    min_p_mask,
    prefill,
    top_k_mask,
    top_p_mask,
)
from distkeras_tpu_torch.models.transformer import (
    TransformerConfig,
    apply,
    apply_hidden,
    init_params,
)
from distkeras_tpu_torch.ops.attention import (
    LAUNCHES,
    blockwise_attention,
    flash_attention,
    naive_attention,
)
from distkeras_tpu_torch.utils.serialization import load_lm, params_from_numpy

__all__ = [
    "LAUNCHES",
    "TransformerConfig",
    "apply",
    "apply_hidden",
    "blockwise_attention",
    "flash_attention",
    "generate",
    "init_cache",
    "init_params",
    "load_lm",
    "min_p_mask",
    "naive_attention",
    "params_from_numpy",
    "prefill",
    "top_k_mask",
    "top_p_mask",
]
