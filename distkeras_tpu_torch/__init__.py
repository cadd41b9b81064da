"""distkeras_tpu_torch: the PyTorch / CUDA (Hopper) port of distkeras_tpu.

A second package beside the JAX one, which stays the reference.  It
serves and trains the decoder-only transformer LM on one GPU:
``generate`` runs a batched prefill through the hand-written
flash-attention forward kernel (``ops/csrc/flash_fwd.cu``), then a
KV-cached decode loop; ``LMTrainer`` / ``make_train_step`` train through
``lm_loss``, whose attention runs the forward kernel with lse and the
hand-written FA2 backward kernels (``ops/csrc/flash_bwd.cu``).

Device rule: entry points run on CUDA by default; with no card they
raise unless called with ``device="cpu"`` (as the tests do).  The port
imports ``torch`` and numpy, never ``jax`` or ``distkeras_tpu``.
"""

from distkeras_tpu_torch.data.packing import pack_documents, packing_efficiency
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
    chunked_softmax_xent,
    init_params,
    lm_loss,
    lm_nll,
    make_train_step,
)
from distkeras_tpu_torch.ops.attention import (
    LAUNCHES,
    blockwise_attention,
    flash_attention,
    naive_attention,
)
from distkeras_tpu_torch.trainers.lm import LMTrainer
from distkeras_tpu_torch.trainers.optim import Optimizer
from distkeras_tpu_torch.utils.serialization import (
    load_lm,
    params_from_numpy,
    params_to_numpy,
)

__all__ = [
    "LAUNCHES",
    "LMTrainer",
    "Optimizer",
    "TransformerConfig",
    "apply",
    "apply_hidden",
    "blockwise_attention",
    "chunked_softmax_xent",
    "flash_attention",
    "generate",
    "init_cache",
    "init_params",
    "lm_loss",
    "lm_nll",
    "load_lm",
    "make_train_step",
    "min_p_mask",
    "naive_attention",
    "pack_documents",
    "packing_efficiency",
    "params_from_numpy",
    "params_to_numpy",
    "prefill",
    "top_k_mask",
    "top_p_mask",
]
