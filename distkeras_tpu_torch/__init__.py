"""distkeras_tpu_torch: the PyTorch / CUDA (Hopper) port of distkeras_tpu.

A second package beside the JAX one, which stays the reference.

The paper's path, on one GPU: a :class:`Dataset` and its transformers,
a model of ``zoo`` (``nn.Module``s with Keras' layouts; weights carry
across with ``module_from_keras_numpy``), the Keras trainer family
(``SingleTrainer``, ``ADAG``, ``DynSGD``, ``AEASGD``, ``EAMSGD``,
``DOWNPOUR``, ``AveragingTrainer``, ``EnsembleTrainer``) over a
:class:`ModelAdapter`, then :class:`ModelPredictor` and
:class:`AccuracyEvaluator`.  Its convolutions and dense products are
cuDNN / cuBLAS; the reference computes them in XLA, outside any Pallas
kernel.

The flagship LM on one GPU:
``generate`` runs a batched prefill through the hand-written
flash-attention forward kernel (``ops/csrc/flash_fwd.cu``), then a
KV-cached decode loop; ``LMTrainer`` / ``make_train_step`` train through
``lm_loss``, whose attention runs the forward kernel with lse and the
hand-written FA2 backward kernels (``ops/csrc/flash_bwd.cu``).  From
raw text: ``BPETokenizer.train`` / ``encode_corpus`` (``native/tokenizer.cc``
through the port's loader) give token rows, a ``Dataset`` of them feeds
``LMTrainer`` (``shuffle``, ``device_data``, ``profile_dir``; ``remat``
configs for long contexts), and ``save_lm`` writes the artefact that
``load_lm`` (here or in the JAX package) serves.

Serving: ``ContinuousBatcher`` admits requests into lanes at any time and
decodes them together (chunked prefill, a ``PrefixPool`` of prefilled
prefixes, elastic lane tiers, deadlines and a bounded queue), and
``SpeculativeBatcher`` / ``speculative_generate`` add a draft model.

The model surface: MoE configs (``num_experts``, top-k capacity routing
in training, dense routing at inference), int8 weights
(``quantize_params``, ``QTensor``) and the int8 KV cache (``kv_int8=``)
through ``generate`` and the engines, and LoRA fine-tuning
(``LoRAConfig``, ``lora_init``, ``lora_merge``, ``LoRATrainer``).

Data parallelism: one process per device in a ``torch.distributed``
group (``deploy.Job`` starts the ranks, ``deploy.init_from_env`` joins
them: NCCL on the cards, gloo with ``device="cpu"``); ADAG, DynSGD, the
replica family and ``LMTrainer`` then run ``num_workers`` = world size
replicas, with the ZeRO stages and the gradient-exchange policies of
``parallel/``, and ``AsyncDP`` simulates a bounded-staleness async fleet
in one process.

Checkpoint and resilience: every trainer takes ``checkpoint_dir`` /
``checkpoint_every`` / ``max_checkpoints`` / ``resume`` and resumes bit
for bit from a :class:`CheckpointManager` step (the pickle layout; in a
process group rank 0 writes the gathered state); a :class:`Supervisor`
retries faults and preemptions around ``train``, and
``resilience.cluster`` restarts a multi-process job under a new cluster
epoch (heartbeats, the collective watchdog, cluster-consistent
checkpoints).

Device rule: entry points run on CUDA by default; with no card they
raise unless called with ``device="cpu"`` (as the tests do).  The port
imports ``torch`` and numpy, never ``jax`` or ``distkeras_tpu``.
"""

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.data.packing import pack_documents, packing_efficiency
from distkeras_tpu_torch.data.prefetch import DeviceFeed, Prefetcher
from distkeras_tpu_torch.data.tokenizer import BPETokenizer
from distkeras_tpu_torch.data.transformers import (
    DenseTransformer,
    LabelIndexTransformer,
    MinMaxTransformer,
    OneHotTransformer,
    ReshapeTransformer,
    StandardScaleTransformer,
    Transformer,
)
from distkeras_tpu_torch.evaluators import (AccuracyEvaluator, Evaluator,
                                            PerplexityEvaluator)
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.models.adapter import ModelAdapter, TrainState
from distkeras_tpu_torch.models.generate import (
    generate,
    init_cache,
    min_p_mask,
    prefill,
    top_k_mask,
    top_p_mask,
)
from distkeras_tpu_torch.models.lora import LoRAConfig, lora_init, lora_merge
from distkeras_tpu_torch.models.quant import QTensor, quantize_params
from distkeras_tpu_torch.models.speculative import speculative_generate
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
from distkeras_tpu_torch.predictors import ModelPredictor, Predictor
from distkeras_tpu_torch.checkpoint import CheckpointManager
from distkeras_tpu_torch.resilience import (ClusterMember, ClusterSupervisor,
                                            FaultPlan, Preempted, Supervisor)
from distkeras_tpu_torch.serving import (ContinuousBatcher, EngineClosed,
                                         PrefixPool, QueueFull, RequestResult,
                                         SpeculativeBatcher, TraceReplay)
from distkeras_tpu_torch import deploy, parallel
from distkeras_tpu_torch.parallel import (AsyncConfig, AsyncSchedule,
                                          MeshSpec, initialize_multihost,
                                          make_mesh)
from distkeras_tpu_torch.trainers.async_dp import AsyncDP
from distkeras_tpu_torch.trainers.base import SingleTrainer, Trainer
from distkeras_tpu_torch.trainers.distributed import ADAG, DynSGD
from distkeras_tpu_torch.trainers.elastic import (AEASGD, DOWNPOUR, EAMSGD,
                                                  AveragingTrainer,
                                                  EnsembleTrainer)
from distkeras_tpu_torch.trainers.lm import LMTrainer, LoRATrainer
from distkeras_tpu_torch.trainers.optim import Optimizer
from distkeras_tpu_torch.utils.serialization import (
    keras_numpy_from_module,
    load_lm,
    lora_from_numpy,
    module_from_keras_numpy,
    params_from_numpy,
    params_to_numpy,
    save_lm,
)

__all__ = [
    "ADAG",
    "CheckpointManager",
    "ClusterMember",
    "ClusterSupervisor",
    "FaultPlan",
    "Preempted",
    "Supervisor",
    "AsyncConfig",
    "AsyncDP",
    "AsyncSchedule",
    "MeshSpec",
    "deploy",
    "initialize_multihost",
    "make_mesh",
    "parallel",
    "ContinuousBatcher",
    "EngineClosed",
    "PrefixPool",
    "QueueFull",
    "RequestResult",
    "SpeculativeBatcher",
    "TraceReplay",
    "speculative_generate",
    "AEASGD",
    "AccuracyEvaluator",
    "AveragingTrainer",
    "BPETokenizer",
    "DOWNPOUR",
    "Dataset",
    "DenseTransformer",
    "DeviceFeed",
    "DynSGD",
    "EAMSGD",
    "EnsembleTrainer",
    "Evaluator",
    "LAUNCHES",
    "LMTrainer",
    "LabelIndexTransformer",
    "LoRAConfig",
    "LoRATrainer",
    "MinMaxTransformer",
    "ModelAdapter",
    "ModelPredictor",
    "OneHotTransformer",
    "Optimizer",
    "PerplexityEvaluator",
    "QTensor",
    "Predictor",
    "Prefetcher",
    "ReshapeTransformer",
    "SingleTrainer",
    "StandardScaleTransformer",
    "TrainState",
    "Trainer",
    "Transformer",
    "TransformerConfig",
    "apply",
    "apply_hidden",
    "blockwise_attention",
    "chunked_softmax_xent",
    "flash_attention",
    "generate",
    "init_cache",
    "init_params",
    "keras_numpy_from_module",
    "lm_loss",
    "lm_nll",
    "load_lm",
    "lora_from_numpy",
    "lora_init",
    "lora_merge",
    "make_train_step",
    "min_p_mask",
    "module_from_keras_numpy",
    "naive_attention",
    "pack_documents",
    "packing_efficiency",
    "params_from_numpy",
    "params_to_numpy",
    "prefill",
    "quantize_params",
    "save_lm",
    "top_k_mask",
    "top_p_mask",
    "zoo",
]
