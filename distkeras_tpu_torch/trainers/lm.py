"""LMTrainer on one GPU: the flagship LM under the trainer-family API.

Counterpart of ``distkeras_tpu/trainers/lm.py::LMTrainer``, one-device
subset: ``LMTrainer(cfg, ...).train(tokens) -> params`` with ``history``,
``eval_history``, ``training_time``, ``probe_history`` and
``ema_params``.  The data order is the reference's, bit for bit: the
shuffle is ``np.random.default_rng(seed).permutation``, each step takes
the next ``batch_size * grad_accum`` rows and the remainder is dropped,
and eval chunks of packed rows are weighted by their valid-target count.

Dataset contract: token rows ``[N, seq_len + 1]`` (inputs plus the
shifted targets, as ``lm_loss`` expects), as an array or as the
``tokens_col`` column of a ``Dataset`` (``BPETokenizer.encode_corpus``
makes them from text), with optional packed ``segments`` of the same
shape (``data.packing.pack_documents``).

``device_data=True`` stages the rows on the device once and gathers each
step's batch there by index; ``profile_dir`` writes a ``torch.profiler``
chrome trace of a few steady steps.  Runs on the card unless
``device="cpu"``.

Data parallelism: one process per device, joined by ``torch.distributed``
(``parallel/mesh.py``); ``batch_size`` is the global batch and rank ``r``
trains on rows ``[r B/n, (r+1) B/n)`` of each microbatch, as
``P("data")`` places them in the reference.  ``zero=1|2|3``,
``merge_rule``, ``sync_every``, ``compress`` / ``topk_frac`` take the
reference's meanings, compositions and refusals.

The model axis and FSDP: ``mesh=make_mesh(MeshSpec(data=d, model=m))``
places the parameters by ``rules`` (default ``tp_rules()``, the
reference's) and ``fsdp=True`` adds the data axis (``_augment_fsdp``);
each rank holds its slices (``parallel/layout.py``), runs its attention
heads and FFN columns between one all-reduce pair a block, gathers the
other splits on use and reduce-scatters their gradients, and the
data-axis exchange runs over its data line.  ``train`` returns the full
tree (a gather), and checkpoints hold full leaves.

The seq, pipeline and expert axes, as the reference picks the forward
for the mesh: a pipeline axis runs ``apply_pipelined`` (``microbatches``,
default ``2 x pipeline``; each rank holds its stage's layers, and with a
seq axis the ring runs inside each stage), else a seq axis runs the
ring (``parallel/ring.py``).  Each seq rank trains on its block of the
sequence (the token window of its inputs and targets), so the gradients
are averaged over data x seq; the leaves the stages share are summed
over the pipeline.  Under a pipeline with a data axis, data rank ``d``
holds rows ``[m mb + d mb / n, m mb + (d + 1) mb / n)`` of each
microbatch ``m``, so a microbatch is the reference's global one.  MoE
configs take any mesh: capacity and aux are the token group's
(``models/transformer.py::_moe_block``), the experts split over
``expert``.

Checkpoints (``checkpoint_dir`` / ``checkpoint_every`` /
``max_checkpoints`` / ``resume``, ``trainers/base.py::
CheckpointingBase``): a round is one optimizer step, and the carry
saved after it holds the parameters, the optimizer state (ZeRO shards
gathered), the EMA shadow, the exchange residuals and the dropout
generator's state, so a resumed run draws the same masks and replays the
uninterrupted run bit for bit.

``LoRATrainer`` fine-tunes LoRA adapters over a frozen base under the
same contract (``distkeras_tpu/trainers/lm.py::LoRATrainer``).
"""

from __future__ import annotations

import contextlib
import math
import time
import warnings

import numpy as np
import torch

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models import transformer as tfm
from distkeras_tpu_torch.models.lora import (LoRAConfig, _validate,
                                             lora_init, lora_mask,
                                             lora_merge, make_lora_loss)
from distkeras_tpu_torch.native import gather_rows
from distkeras_tpu_torch.parallel.collectives import (DataParallel,
                                                      ZeroOptimizer,
                                                      all_reduce, gather_bucket,
                                                      gather_tree, scatter,
                                                      true_div,
                                                      zero_validate)
from distkeras_tpu_torch.parallel.exchange import (ExchangeConfig,
                                                   ExchangeOptimizer,
                                                   merge_local_params,
                                                   residual_norm_of)
from distkeras_tpu_torch.parallel.layout import Layout, Sharded
from distkeras_tpu_torch.parallel.mesh import AXES, make_mesh
from distkeras_tpu_torch.parallel.ring import make_ring_attention
from distkeras_tpu_torch.parallel.sharding import ShardingPlan
from distkeras_tpu_torch.parallel.tree import tree_leaves
from distkeras_tpu_torch.trainers.base import (CheckpointingBase,
                                               normalize_zero_args)
from distkeras_tpu_torch.trainers.carry import (copy_leaves, load_opt_tree,
                                                local_tree, opt_tree,
                                                placed_tree, row_of,
                                                stack_tree, zero_pieces)
from distkeras_tpu_torch.trainers.optim import LM_NAMES, Optimizer
from distkeras_tpu_torch.utils.device import check_on_device, resolve_device
from distkeras_tpu_torch.utils import profiling
from distkeras_tpu_torch.utils.misc import nll_to_perplexity

# Staging more than this fraction of the device's memory fails fast (the
# rest of the step still needs activations, params and moments).
_STAGING_FRACTION = 0.8
# With no device memory report (the CPU), only an absurd estimate warns.
_STAGING_SANITY_BYTES = 8 << 30


def _device_bytes_limit(device: torch.device) -> int | None:
    """The card's memory in bytes, or None on the CPU (which reports no
    budget).  Module-level so tests can patch in a small budget."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[1]


def _make_zero_step(cfg: tfm.TransformerConfig, zopt: ZeroOptimizer,
                    mesh, stage: int, grad_accum: int, probe: bool):
    """The ZeRO stage-2/3 train step (``distkeras_tpu/trainers/lm.py::
    _make_zero_step``): each microbatch's gradient buckets are
    reduce-scattered into this rank's accumulated rows as they are made,
    so a rank only keeps its ``1/n`` gradient shard; the update runs on
    the shards.  Stage 2 keeps ``params`` whole and all-gathers the new
    parameters; stage 3 takes ``params`` as the shards (a tree of
    ``[cols]`` leaves), gathers each bucket on use inside the loss
    (``gather_bucket``) and has no parameter gather after the update."""
    n = mesh.size

    def step(carry, tokens, dropout_rng=None, segment_ids=None):
        params, zs = carry
        layout = zs.layout
        rng = dropout_rng if cfg.dropout > 0 else None
        leaves = tree_leaves(params)
        acc, loss = None, None
        for i in range(grad_accum):
            tok = tokens[i] if grad_accum > 1 else tokens
            seg = (None if segment_ids is None else segment_ids[i]
                   if grad_accum > 1 else segment_ids)
            with torch.enable_grad():
                if stage >= 3:
                    full = layout.unflatten(layout.unpack(
                        [gather_bucket(r, mesh)
                         for r in layout.pack_rows(leaves)]))
                    li = tfm.lm_loss(full, tok, cfg, dropout_rng=rng,
                                     segment_ids=seg)
                    rows = layout.pack_rows(torch.autograd.grad(li, leaves))
                else:
                    li = tfm.lm_loss(params, tok, cfg, dropout_rng=rng,
                                     segment_ids=seg)
                    grads = torch.autograd.grad(li, leaves,
                                                allow_unused=True)
                    grads = [torch.zeros_like(p) if g is None else g
                             for p, g in zip(leaves, grads)]
                    rows = [scatter(b, mesh) for b in layout.pack(grads)]
            acc = rows if acc is None else [a + r for a, r in zip(acc, rows)]
            loss = li.detach() if loss is None else loss + li.detach()
        zopt.set_shard_grads(zs, [true_div(a, n * grad_accum) for a in acc])
        norm = zopt.grad_norm(None, zs) if probe else None
        if stage >= 3:
            zopt.step_shards(zs)
        else:
            zopt.update(params, zs)
        for s_ in zs.shards:
            s_.grad = None
        loss = loss / grad_accum
        if probe:
            return (params, zs), (loss, {"grad_norm": norm})
        return (params, zs), loss

    return step


def _make_localsgd_step(cfg: tfm.TransformerConfig, optimizer: Optimizer,
                        mesh, config):
    """Local SGD (``distkeras_tpu/trainers/lm.py::_make_localsgd_step``):
    ``step((params, opt), tokens[H, B/n, S+1])`` takes ``H =
    config.sync_every`` purely local optimizer steps on this rank's
    rows, then one merge over the group — the parameter deltas by the
    configured rule (per fusion bucket) and the floating optimizer state
    averaged.  The loss is this rank's mean over the period."""
    from distkeras_tpu_torch.models.adapter import sync_optimizer_state

    def step(carry, tokens, dropout_rng=None, segment_ids=None):
        if dropout_rng is not None or segment_ids is not None:
            raise ValueError(
                "sync_every > 1 does not support dropout or packed "
                "segments (replica-local loss)")
        params, opt_state = carry
        leaves = tree_leaves(params)
        start = [p.detach().clone() for p in leaves]
        losses = []
        for h in range(tokens.shape[0]):
            for p in leaves:
                p.grad = None
            loss = tfm.lm_loss(params, tokens[h], cfg)
            loss.backward()
            optimizer.update(params, opt_state)
            losses.append(loss.detach())
        with torch.no_grad():
            for p, v in zip(leaves, merge_local_params(start, leaves, config,
                                                       mesh)):
                p.copy_(v)
            sync_optimizer_state(opt_state, config, mesh)
        for p in leaves:
            p.grad = None
        return (params, opt_state), torch.stack(losses).mean()

    return step


def _token_axes(mesh):
    """The one-axis meshes over which a step's tokens differ (data, and
    seq, whose ranks hold blocks of the sequence), sized above 1."""
    return [mesh.sub(a) for a in ("data", "seq") if int(mesh.shape[a]) > 1]


def _global_count_loss(fn, mesh):
    """``fn`` (an ``lm_loss``) rescaled for packed rows split over the
    data (and seq) ranks: the reference's mean runs over the global
    batch's valid targets, so this rank's mean over its own ``c`` of
    them is scaled by ``c n / C`` (``C`` summed over those ``n`` ranks)
    — the mean of the scaled losses is the global mean, and so is its
    gradient."""
    axes = _token_axes(mesh)
    n = math.prod(a.size for a in axes)

    def loss(params, tokens, cfg, attention_fn, apply_fn, rng, hidden_fn,
             segment_ids=None):
        out = fn(params, tokens, cfg, attention_fn, apply_fn, rng,
                 hidden_fn, segment_ids)
        if segment_ids is None:
            return out
        seg = segment_ids.to(torch.int32)
        c = ((seg[:, 1:] == seg[:, :-1]) & (seg[:, :-1] != 0)).sum().float()
        total = c.clone()
        for a in axes:
            total = all_reduce(total, a)
        return out * (c * n) / total.clamp(min=1.0)

    return loss


def _mean_over(x, axes):
    """The mean of ``x`` over the ranks of ``axes`` (in place)."""
    for a in axes:
        x = true_div(all_reduce(x, a), a.size)
    return x


def _valid_targets(seg) -> int:
    """Trainable targets of packed rows: the target continues its
    input's (nonzero) segment."""
    return int(((seg[:, 1:] == seg[:, :-1]) & (seg[:, :-1] != 0)).sum())


class LMTrainer(CheckpointingBase):
    """Train a causal transformer LM on one device.

    ``optimizer`` is one of ``adam`` / ``adamw`` / ``sgd`` (optax's
    defaults, see ``trainers.optim``); ``learning_rate`` may be a schedule
    of the step count.  ``grad_accum`` microbatches of ``batch_size`` rows
    make one step; ``probe_metrics`` records the global gradient norm per
    step (``probe_history``); ``ema_decay`` keeps an EMA of the weights
    (``ema_params``).  Dropout (``cfg.dropout > 0``) draws its masks from
    one generator seeded with ``seed + 0x5eed``.

    ``device_data=True`` stages the (shuffled) int32 rows on the device
    once, in consumption order, behind an HBM guard, and each step
    gathers its rows there by index: the reference's one-device
    ``_stage_stream``, the same data order as streaming.
    ``profile_dir`` traces optimizer rounds ``[2, 2 + profile_steps)``
    (round 1 pays the first-call set-up) with ``utils.profiling.trace``
    and writes a chrome trace there (``profile_path``), where the train
    step's ``obs`` spans show by name under a session; a resumed run
    counts them from its first executed round.
    """

    def __init__(self, cfg: tfm.TransformerConfig, optimizer: str = "adamw",
                 learning_rate=3e-4, weight_decay: float | None = None,
                 batch_size: int = 8, num_epoch: int = 1,
                 grad_accum: int = 1, grad_clip_norm: float | None = None,
                 probe_metrics: bool = False, seed: int = 0,
                 shuffle: bool = False, eval_every: int = 0,
                 ema_decay: float | None = None, device_data: bool = False,
                 tokens_col: str = "tokens", profile_dir: str | None = None,
                 profile_steps: int = 3, device=None, mesh=None,
                 rules=None, fsdp: bool = False,
                 zero: int | None = None, zero1: bool = False,
                 zero1_bucket_mb: float | None = None,
                 zero_bucket_mb: float | None = None,
                 merge_rule: str = "mean", sync_every: int = 1,
                 compress=None, topk_frac: float = 0.01,
                 checkpoint_dir: str | None = None, checkpoint_every: int = 0,
                 max_checkpoints: int = 3, resume: bool = False,
                 checkpoint_backend: str = "auto",
                 microbatches: int | None = None):
        zero, zero1, zero_bucket_mb = normalize_zero_args(
            zero, zero1, zero_bucket_mb, zero1_bucket_mb)
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if eval_every < 0:
            raise ValueError(f"eval_every must be >= 0, got {eval_every}")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if profile_steps < 1:
            raise ValueError(
                f"profile_steps must be >= 1, got {profile_steps}")
        if probe_metrics and device_data:
            raise ValueError(
                "probe_metrics does not compose with device_data=True "
                "(the staged-stream step has no probe output slot)")
        if optimizer not in LM_NAMES:
            raise ValueError(f"unknown optimizer {optimizer!r}; known: "
                             f"{sorted(LM_NAMES)}")
        self.cfg = cfg
        self.optimizer = Optimizer(optimizer, learning_rate, weight_decay,
                                   grad_clip_norm, ema_decay)
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh()
        missing = [a for a in AXES if a not in self.mesh.shape]
        if missing:
            raise ValueError(
                f"mesh is missing axes {missing}: LMTrainer needs the "
                f"canonical axis set {AXES} (build the mesh with "
                "parallel.mesh.make_mesh / MeshSpec, which always carries "
                "all five, sized 1 when unused)")
        n = self.mesh.size
        n_pipe = int(self.mesh.shape["pipeline"])
        n_seq = int(self.mesh.shape["seq"])
        n_model = int(self.mesh.shape["model"])
        if (n_model > 1 and rules is None and cfg.n_kv_heads is not None
                and cfg.kv_heads % n_model):
            raise ValueError(
                f"GQA with Megatron TP: n_kv_heads={cfg.kv_heads} must "
                f"divide by the mesh model axis ({n_model}) — the default "
                "tp_rules shard K/V projections over their head "
                "dimension. Use more KV heads, a smaller model axis, or "
                "custom rules.")
        if cfg.dropout > 0 and n_pipe > 1:
            raise ValueError(
                "cfg.dropout > 0 cannot compose with a pipeline axis > 1: "
                "the pipeline's tick schedule is compiled without a "
                "per-microbatch rng stream (TransformerConfig.dropout). "
                "Train with dropout on a dp/tp/sp/fsdp mesh, or drop the "
                "regularizer under PP.")
        if fsdp and n_pipe > 1:
            raise ValueError(
                "fsdp=True cannot compose with a pipeline axis > 1: the "
                "pipelined trunk runs in a manual shard_map over "
                "{pipeline, seq} whose in_specs take the stage-stacked "
                "parameters whole. Shard memory across pipeline stages "
                "instead (that is what PP does), or drop the pipeline axis.")
        if microbatches is not None and n_pipe <= 1:
            raise ValueError(
                "microbatches only applies with a pipeline mesh axis > 1 "
                f"(mesh has pipeline={n_pipe})")
        self.microbatches = microbatches or (2 * n_pipe if n_pipe > 1 else 1)
        self.fsdp = fsdp
        self.plan = ShardingPlan(
            rules=tfm.tp_rules() if rules is None else rules,
            fsdp_axis="data" if fsdp else None)
        if self.mesh.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(
                f"the process group runs NCCL but the trainer's device is "
                f"{self.device}; CPU ranks join with gloo (device='cpu')")
        if batch_size % n:
            raise ValueError(
                f"batch_size={batch_size} (the global batch) must divide "
                f"by the data axis ({n} ranks)")
        if zero_bucket_mb is not None and not zero:
            raise ValueError(
                "zero_bucket_mb/zero1_bucket_mb only apply with a "
                "ZeRO stage (zero=/zero1=True)")
        exchange = ExchangeConfig(
            merge_rule=merge_rule, sync_every=sync_every,
            compress=compress, topk_frac=topk_frac,
            **({} if zero_bucket_mb is None
               else {"bucket_mb": zero_bucket_mb}))
        if not exchange.is_default:
            pure_dp = (n_model == 1 and n_seq == 1 and n_pipe == 1
                       and int(self.mesh.shape["expert"]) == 1
                       and not fsdp and not cfg.num_experts)
            if not pure_dp:
                raise ValueError(
                    "merge_rule/sync_every/compress compose with the "
                    "pure data-parallel mesh only (no model/seq/"
                    "pipeline/expert axes, no fsdp, no MoE): the "
                    "exchange layer computes per-replica gradients in "
                    "a shard_map over the data axis")
            if cfg.dropout > 0:
                raise ValueError(
                    "merge_rule/sync_every/compress do not compose "
                    "with cfg.dropout > 0: the dropout mask stream is "
                    "a global-batch quantity a replica-local loss "
                    "would draw differently")
            if device_data:
                raise ValueError(
                    "merge_rule/sync_every/compress do not compose "
                    "with device_data=True: the staged data plane "
                    "does not route through the local-gradient "
                    "shard_map")
            if zero and not (zero == 1 and exchange.compress == "int8"
                             and exchange.sync_every == 1):
                raise ValueError(
                    "the ZeRO stages compose with zero=1 + "
                    "compress='int8' only (the chunked codec compresses "
                    "the reduce-scatter leg); adasum, local-SGD, codec "
                    "rules and stages 2/3 replace the exchange the "
                    "sharded update rides")
            if exchange.sync_every > 1 and grad_accum > 1:
                raise ValueError(
                    "sync_every > 1 with grad_accum > 1 is not "
                    "supported: the local-SGD period already scans "
                    "sync_every microbatches per call")
        if probe_metrics and exchange.sync_every > 1:
            raise ValueError(
                "probe_metrics with sync_every > 1 is not supported: "
                "the local-SGD period has no single per-step global "
                "gradient to probe")
        if zero:
            if fsdp:
                raise ValueError(
                    f"zero={zero} (chunk-major ZeRO) and fsdp=True "
                    "(the GSPMD dimension-sharded ZeRO-3 spelling) are "
                    "exclusive: they are alternative placements for "
                    "the same state")
            zero_validate(self.mesh, optimizer, stage=zero)
        # The forward for the mesh, as the reference picks it: the
        # pipelined trunk (the ring inside each stage under a seq axis,
        # the chunked head on its hidden states), else the ring.
        if n_pipe > 1:
            chunked = cfg.ce_chunks > 1

            def fwd(p, t, seg=None):
                return tfm.apply_pipelined(
                    p, t, cfg, self.mesh, microbatches=self.microbatches,
                    seq_axis="seq" if n_seq > 1 else None,
                    return_hidden=chunked, segment_ids=seg)

            fwd.handles_segments = True
            self._fwd_kw = {"hidden_fn" if chunked else "apply_fn": fwd}
        elif n_seq > 1:
            self._fwd_kw = {"attention_fn": make_ring_attention(
                self.mesh, causal=True, window=cfg.attention_window)}
        else:
            self._fwd_kw = {}
        self.zero, self.zero1 = zero, zero1
        # The placement of the last train() call (None: every leaf whole).
        self.layout = None
        self._zero_bucket_mb = zero_bucket_mb
        self.exchange = exchange
        self.residual_norm = None
        self.batch_size = batch_size
        self.num_epoch = num_epoch
        self.grad_accum = grad_accum
        self.probe_metrics = probe_metrics
        self.seed = seed
        self.shuffle = shuffle
        self.eval_every = eval_every
        self.device_data = device_data
        self.tokens_col = tokens_col
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self.profile_path: str | None = None
        self.history: list[float] = []
        # [(round, {"loss", "perplexity"})]; round -1 = the final state.
        self.eval_history: list[tuple[int, dict]] = []
        self.probe_history: list[dict] = []
        self.training_time = 0.0
        self._ema_params = None
        # The optimizer state of the last train() call.
        self.opt_state = None
        # The train step's loss (None: lm_loss); LoRATrainer's merges.
        self._loss_fn = None
        self._setup_checkpointing(
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            max_checkpoints=max_checkpoints, resume=resume, shuffle=shuffle,
            seed=seed, backend=checkpoint_backend)

    @property
    def ema_params(self):
        """EMA weights from the last ``train`` call (requires
        ``ema_decay``); None before training."""
        if self.optimizer.ema_decay is None:
            raise ValueError("ema_params requires ema_decay= on the "
                             "constructor")
        return self._ema_params

    def init_params(self):
        return tfm.init_params(self.seed, self.cfg, device=self.device)

    def _placement(self, params):
        """``(params, layout)``: ``params`` as this rank's slices under
        the plan when the mesh splits any leaf (a model axis above 1, or
        fsdp over a data axis above 1), else as they are with None.  A
        tree placed already keeps its layout."""
        if isinstance(params, Sharded):
            return params, params.layout
        if self.zero or self._loss_fn is not None \
                or self.mesh.world_size == 1:
            return params, None
        layout = Layout(self.plan, self.mesh, params)
        # A seq, pipeline or expert axis, or MoE over the data axis, runs
        # on the layout's handles even with nothing split.
        axes = any(int(self.mesh.shape[a]) > 1 for a in (
            "pipeline", "seq", "expert")) or (
            self.cfg.num_experts and self.mesh.size > 1)
        if not (axes or layout.native or any(layout.gathers.values())):
            return params, None
        return layout.shard(params), layout

    def _dp_optimizer(self):
        """The optimizer the step drives: ``self.optimizer`` wrapped for
        this configuration's exchange over the group (none for a single
        process and the default exchange, the inner one for local SGD,
        whose step merges by itself)."""
        opt, mesh, ex = self.optimizer, self.mesh, self.exchange
        if self.layout is not None:
            return DataParallel(opt, mesh, layout=self.layout)
        bucket_mb = self._zero_bucket_mb or ex.bucket_mb
        if self.zero == 1 and ex.compress == "int8":
            return ExchangeOptimizer(opt, mesh, ex, zero1=True)
        if self.zero:
            return ZeroOptimizer(opt, mesh, bucket_mb)
        if ex.needs_grad_exchange:
            return ExchangeOptimizer(opt, mesh, ex)
        if ex.sync_every == 1 and mesh.group is not None:
            return DataParallel(opt, mesh)
        return opt

    def _nll(self, params, tokens, segment_ids=None):
        """The evaluation NLL of the trained state (on this rank's block
        of the rows under a seq axis, through the mesh's forward)."""
        return tfm.lm_nll(params, tokens, self.cfg, segment_ids=segment_ids,
                          **self._fwd_kw)

    def _window(self, rows):
        """This seq rank's token window of ``[.., S+1]`` rows: its block
        of the inputs with their targets (columns ``[q S/n, (q+1) S/n +
        1)``), the whole rows without a seq axis."""
        sq = self.mesh.sub("seq")
        if sq.size == 1:
            return rows
        w = (rows.shape[-1] - 1) // sq.size
        return rows[..., sq.rank * w:(sq.rank + 1) * w + 1]

    def _rows(self, a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device,
                                                            dtype)

    def _guard_staged_bytes(self, n_rows: int, width: int,
                            with_segments: bool) -> None:
        """Fail fast when ``device_data=True`` would stage more than
        ``_STAGING_FRACTION`` of the device's memory (int32 rows, doubled
        with segments), instead of failing in the allocator later; on
        the CPU, which reports no budget, only warn past an absurd size."""
        staged = n_rows * width * 4 * (2 if with_segments else 1)
        limit = _device_bytes_limit(self.device)
        msg = (f"device_data=True would stage {staged / 2**20:.1f} MiB of "
               "token rows" + (" (segments included)" if with_segments
                               else ""))
        if limit is not None and staged > _STAGING_FRACTION * limit:
            raise ValueError(
                f"{msg}, over {int(_STAGING_FRACTION * 100)}% of the "
                f"{limit / 2**20:.1f} MiB device budget — train with "
                "device_data=False (the streaming path) or trim the "
                "dataset")
        if limit is None and staged > _STAGING_SANITY_BYTES:
            warnings.warn(
                f"{msg}; this device reports no memory budget, but that "
                "figure rarely fits — device_data=False streams from the "
                "host instead", stacklevel=4)

    def train(self, dataset, params=None, eval_tokens=None, segments=None,
              eval_segments=None):
        """Train over the token rows (an array, or a ``Dataset`` whose
        ``tokens_col`` holds them); returns the trained params (a new
        dict: the caller's ``params`` are not modified).

        ``eval_tokens [M, seq+1]`` (with ``eval_every``) runs a held-out
        NLL / perplexity evaluation every ``eval_every`` steps and once at
        the end (round -1) into ``eval_history``, in ``batch_size`` chunks
        (a remainder of up to ``batch_size - 1`` rows is dropped).
        ``segments`` (and ``eval_segments``): packed-sequence ids aligned
        with the rows.
        """
        tokens = np.asarray(dataset[self.tokens_col]
                            if isinstance(dataset, Dataset) else dataset)
        if tokens.ndim != 2:
            raise ValueError(f"tokens must be [N, seq+1], got {tokens.shape}")
        if segments is not None:
            segments = np.asarray(segments)
            if segments.shape != tokens.shape:
                raise ValueError(
                    f"segments must align with the token rows "
                    f"{tokens.shape}, got {segments.shape}")
        if eval_segments is not None and segments is None:
            raise ValueError("eval_segments without segments — pack "
                             "train and eval the same way")
        if self.shuffle:
            # The reference's permutation; the rows are gathered by the
            # native threaded loader when it builds.
            perm = np.random.default_rng(self.seed).permutation(len(tokens))
            tokens = gather_rows(tokens, perm)
            if segments is not None:
                segments = gather_rows(segments, perm)
        self.eval_history = []
        self.profile_path = None
        if self.eval_every and eval_tokens is None:
            raise ValueError("eval_every is set but train() got no "
                             "eval_tokens")
        bs = self.batch_size
        n_data = self.mesh.size
        n_seq = int(self.mesh.shape["seq"])
        seq_len = tokens.shape[1] - 1
        if n_seq > 1 and seq_len % n_seq:
            raise ValueError(
                f"sequence length {seq_len} (token rows carry seq+1 = "
                f"{tokens.shape[1]} positions) must divide by the mesh seq "
                f"axis ({n_seq}) for ring attention to shard it")
        divisor = n_data * (self.microbatches
                            if int(self.mesh.shape["pipeline"]) > 1 else 1)
        if bs % divisor:
            raise ValueError(
                f"batch_size={bs} must divide by data axis ({n_data})"
                + (f" x microbatches ({self.microbatches})"
                   if divisor != n_data else ""))
        if eval_tokens is not None:
            eval_tokens = np.asarray(eval_tokens)
            if (eval_tokens.ndim != 2
                    or eval_tokens.shape[1] != tokens.shape[1]):
                raise ValueError(
                    f"eval_tokens must be [M, {tokens.shape[1]}] like the "
                    f"training rows, got {eval_tokens.shape}")
            if (eval_segments is not None
                    and np.shape(eval_segments) != eval_tokens.shape):
                raise ValueError(
                    f"eval_segments must align with eval_tokens "
                    f"{eval_tokens.shape}, got {np.shape(eval_segments)}")
            if len(eval_tokens) < bs:
                raise ValueError(
                    f"eval_tokens has {len(eval_tokens)} rows; one eval "
                    f"batch needs {bs}")
        # The leading block of one step: the grad-accum depth or the
        # local-SGD period (exclusive by construction).
        feed = (self.grad_accum if self.grad_accum > 1
                else self.exchange.sync_every)
        rows_per_step = bs * feed
        n_rows = len(tokens) - (len(tokens) % rows_per_step)
        if not n_rows:
            raise ValueError(
                f"dataset has {len(tokens)} rows; one step needs "
                f"{rows_per_step} (batch_size x grad_accum)")
        mesh = self.mesh
        n, rank = mesh.size, mesh.rank
        if n > 1 and self.exchange.needs_grad_exchange \
                and segments is not None:
            raise ValueError(
                "gradient-exchange configurations do not support dropout "
                "or packed segments (replica-local loss)")
        b = bs // n  # this rank's rows of each microbatch
        # This rank's stream rows, in consumption order: step j's block
        # [feed, bs] holds its rows [:, rank * b:(rank + 1) * b] — or,
        # under a pipeline, its share of each pipeline microbatch.
        mine = self._rows_of(np.arange(n_rows).reshape(-1, feed, bs),
                             rank).reshape(-1)

        t0 = time.perf_counter()
        self.opt_state = None  # free the last run's state first
        # Fail fast on a populated checkpoint_dir before paying the
        # parameter init.
        self._open_checkpoints()
        try:
            params = self._train(tokens, segments, eval_tokens,
                                 eval_segments, params, feed, rows_per_step,
                                 n_rows, mine, b)
        finally:
            self._close_checkpoints()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.training_time = time.perf_counter() - t0
        self._record_run_metrics()
        return params

    def _rows_of(self, rows, rank: int):
        """Data rank ``rank``'s share of ``[..., B]`` row indices: the
        block ``[rank B/n, (rank+1) B/n)``, or under a pipeline of ``m``
        microbatches its ``B/(n m)`` rows of each microbatch."""
        n, bs = self.mesh.size, rows.shape[-1]
        m = (self.microbatches if int(self.mesh.shape["pipeline"]) > 1
             else 1)
        split = rows.reshape(*rows.shape[:-1], m, n, bs // (n * m))
        return split[..., rank, :].reshape(*rows.shape[:-1], bs // n)

    def _publish_tree(self, tree_fn):
        """Live weight push: the full parameters of the running round (a
        gather under ZeRO-3, only on publish rounds)."""
        return self._publish_params()

    def _carry_tree(self, carry, drop, full_params,
                    local: bool = False) -> dict:
        """The checkpoint tree of the round carry: the full parameters,
        the optimizer state (``trainers/carry.py``: ZeRO shards gathered,
        EMA, exchange residuals) and every rank's dropout generator
        state (a collective in a process group).  ``local``: the
        local-shard tree — this rank's pieces of each, nothing
        gathered."""
        params, opt_state = carry
        if not local:
            p_tree = full_params()
        elif self.zero >= 3:
            p_tree = opt_state.layout.unflatten(zero_pieces(
                opt_state.layout, opt_state.shards, self.mesh.rank))
        elif self.layout is not None:
            p_tree = placed_tree(self.layout, params)
        else:
            p_tree = params
        tree = {"params": p_tree,
                "opt": opt_tree(opt_state, params, self.mesh, self.layout,
                                local),
                "dropout": None}
        if drop is not None:
            tree["dropout"] = stack_tree(drop.get_state(),
                                         self._drop_mesh()[0], local)
        return tree

    def _drop_mesh(self):
        """``(mesh, rank)`` the dropout states stack over: the data axis,
        or the whole grid under a seq axis (whose ranks draw apart)."""
        if int(self.mesh.shape["seq"]) > 1:
            whole = self.mesh.whole()
            return whole, whole.rank
        return self.mesh, self.mesh.rank

    def _load_carry(self, carry, drop, tree) -> None:
        """Load a checkpoint tree into the fresh carry and generator."""
        params, opt_state = carry
        full = dict(tfm.named_leaves(tree["params"]))
        if self.layout is not None:  # this rank's slices of each leaf
            copy_leaves(params, local_tree(self.layout, tree["params"]))
        elif self.zero < 3:  # stage 3's params are the shards: below
            copy_leaves(params, tree["params"])
        load_opt_tree(opt_state, params, tree["opt"], self.mesh,
                      full_params=full, layout=self.layout)
        if drop is not None:
            drop.set_state(
                row_of(tree["dropout"], self._drop_mesh()[1]).cpu().clone())

    def _carry_and_step(self, params, packed: bool = False):
        """THE train step of this configuration and the carry it drives:
        ``(params, opt_state, step, dropout_generator)``, with
        ``self.layout`` set.  ``train`` and :meth:`traced_for_analysis`
        share this one construction, so the census records the step
        that trains.  ``params`` None: a fresh init from ``seed``;
        ``packed``: the rows carry segments."""
        mesh = self.mesh
        n, rank = mesh.size, mesh.rank
        if params is None:
            params = self.init_params()
        else:
            check_on_device(params, self.device)
            params = tfm._map_leaves(lambda p: p.detach().clone(), params)
        params, self.layout = self._placement(params)
        opt = self._dp_optimizer()
        opt_state = opt.init(params)
        if self.zero >= 3:
            # The persistent params are this rank's shards from here on.
            params = opt_state.layout.unflatten(opt_state.shards)
        if self.exchange.sync_every > 1:
            step = _make_localsgd_step(self.cfg, self.optimizer, mesh,
                                       self.exchange)
        elif self.zero >= 2:
            step = _make_zero_step(self.cfg, opt, mesh, self.zero,
                                   self.grad_accum, self.probe_metrics)
        else:
            loss_fn = self._loss_fn
            if _token_axes(mesh) and packed:
                loss_fn = _global_count_loss(loss_fn or tfm.lm_loss, mesh)
            step = tfm.make_train_step(self.cfg, opt,
                                       grad_accum=self.grad_accum,
                                       loss_fn=loss_fn,
                                       probe=self.probe_metrics,
                                       **self._fwd_kw)
        drop = None
        if self.cfg.dropout > 0:
            # Each rank draws its own masks (its rows differ; a seq rank
            # holds other positions of them).
            drop = torch.Generator(self.device).manual_seed(
                self.seed + 0x5eed + rank
                + n * int(mesh.coords["seq"] if mesh.coords else 0))
        return params, opt_state, step, drop

    def _host_block(self, tokens, segments, rows, feed: int, b: int):
        """This rank's ``rows`` of the host token rows (and segments) on
        the device, shaped ``[feed, B/n, S+1]`` when a step has a
        leading block, cut to this seq rank's window."""
        n = self.mesh.size
        block = self._rows(tokens[rows] if n > 1 else
                           tokens[rows[0]:rows[-1] + 1], torch.long)
        seg = None
        if segments is not None:
            seg = self._rows(segments[rows], torch.int32)
        if feed > 1:
            block = block.reshape(feed, b, -1)
            if seg is not None:
                seg = seg.reshape(feed, b, -1)
        return self._window(block), None if seg is None else self._window(seg)

    def traced_for_analysis(self, tokens=None, params=None):
        """The census target (``analysis/ir_lint.py``): the train step
        this configuration executes (:meth:`_carry_and_step`, the one
        ``train`` builds) over a fresh carry (from ``params`` as
        ``train(params=)`` takes them, else the seeded init), fed this
        rank's rows of the first step of ``tokens`` exactly as
        ``train(tokens)`` feeds them (default: seeded random rows of
        ``cfg.max_len`` inputs).  Running the spec's step is one
        optimizer round of ``train``."""
        from distkeras_tpu_torch.analysis.ir_lint import TraceSpec

        feed = (self.grad_accum if self.grad_accum > 1
                else self.exchange.sync_every)
        rows_per_step = self.batch_size * feed
        if tokens is None:
            rng = np.random.default_rng(self.seed)
            tokens = rng.integers(
                0, self.cfg.vocab_size,
                (rows_per_step, self.cfg.max_len + 1)).astype(np.int32)
        tokens = np.asarray(tokens)
        params, opt_state, step, drop = self._carry_and_step(params)
        n, b = self.mesh.size, self.batch_size // self.mesh.size
        mine = self._rows_of(np.arange(rows_per_step).reshape(
            -1, feed, self.batch_size), self.mesh.rank).reshape(-1)
        block, _ = self._host_block(tokens, None, mine[:feed * b], feed, b)
        if self.zero >= 3:
            pbytes = sum(s.size * s.dtype.itemsize
                         for s in opt_state.layout.slots)
        else:
            full = (self.layout.full_shapes if self.layout is not None
                    else {})
            pbytes = sum(math.prod(full.get(k, p.shape)) * p.element_size()
                         for k, p in tfm.named_leaves(params))
        variant = (f"zero{self.zero}" if self.zero
                   else "fsdp" if self.fsdp else "dp")
        if not self.exchange.is_default:
            label = self.exchange.label()
            variant = f"zero1_{label}" if self.zero1 else label
        placements = {}
        if self.layout is not None:
            placements = {k: repr(tuple(v))
                          for k, v in self.layout.specs.items()}
        return [TraceSpec(
            name=f"{type(self).__name__.lower()}_{variant}/train_step",
            fn=step, args=((params, opt_state), block, drop, None),
            params_bytes=int(pbytes),
            group_sizes={a: int(s) for a, s in self.mesh.shape.items()
                         if int(s) > 1},
            zero_stage=self.zero, window=feed,
            state={"params": params, "opt": opt_state},
            placements=placements)]

    def _train(self, tokens, segments, eval_tokens, eval_segments, params,
               feed, rows_per_step, n_rows, mine, b):
        """The run behind :meth:`train`, inside the checkpoint manager's
        lifetime; returns the trained params."""
        bs, mesh = self.batch_size, self.mesh
        n, rank = mesh.size, mesh.rank
        params, opt_state, step, drop = self._carry_and_step(
            params, packed=segments is not None)
        layout = self.layout

        def full_params():
            if self.zero >= 3:
                return gather_tree(opt_state.layout, opt_state.shards, mesh)
            if layout is not None:
                return layout.gather(params)
            return params

        # What _publish_tree publishes: the parameters alone, with no
        # optimizer tree built for it.
        self._publish_params = full_params

        eval_fn = None
        if eval_tokens is not None:
            n_eval = len(eval_tokens) - (len(eval_tokens) % bs)
            # MoE capacity is a group statistic: each data rank scores
            # its share of a chunk's rows, as it trains.
            split = bool(self.cfg.num_experts) and n > 1
            share = (self._rows_of(np.arange(bs), rank) if split
                     else np.arange(bs))
            axes = ([mesh] if split else []) + [
                a for a in _token_axes(mesh) if a is not mesh]
            chunks, seg_chunks = [], None
            for j in range(0, n_eval, bs):
                chunks.append(self._window(self._rows(
                    eval_tokens[j:j + bs][share], torch.long)))
            if eval_segments is not None:
                eval_segments = np.asarray(eval_segments)
                seg_chunks = [self._window(self._rows(
                    eval_segments[j:j + bs][share], torch.int32))
                    for j in range(0, n_eval, bs)]

            def score(p_eval, i):
                """This rank's (NLL x count, count) of chunk ``i``."""
                c, sc = chunks[i], None if seg_chunks is None \
                    else seg_chunks[i]
                nll = self._nll(p_eval, c, sc)
                cnt = (c.shape[0] * (c.shape[1] - 1) if sc is None
                       else _valid_targets(sc.cpu().numpy()))
                return torch.stack([nll.double() * cnt,
                                    nll.new_tensor(cnt, dtype=torch.float64)])

            @torch.no_grad()
            def eval_fn(rnd):
                # A placed tree evaluates split, as it trains.
                p_eval = params if layout is not None else full_params()
                sums = [score(p_eval, i) for i in range(len(chunks))]
                if axes:
                    red = torch.stack(sums)
                    for a in axes:
                        red = all_reduce(red, a)
                    sums = list(red)
                if seg_chunks is None:  # each chunk's mean, averaged
                    mean = sum(float(t[0] / t[1]) for t in sums) / len(sums)
                else:  # weighted by valid-target counts
                    tot = torch.stack(sums).sum(dim=0)
                    mean = float(tot[0] / tot[1].clamp(min=1))
                self.eval_history.append(
                    (rnd, {"loss": mean,
                           "perplexity": nll_to_perplexity(mean)}))

            if self.profile_dir and self.eval_every:
                # Warm the eval call, so an eval round inside the capture
                # records its steady run, not its first-call set-up.
                with torch.no_grad():
                    score(params if layout is not None else full_params(),
                          0)

        X_dev = seg_dev = None
        local_rows = feed * b
        if self.device_data:
            self._guard_staged_bytes(len(mine), tokens.shape[1],
                                     segments is not None)
            X_dev = self._rows(np.asarray(tokens[mine], np.int32),
                               torch.int32)
            if segments is not None:
                seg_dev = self._rows(np.asarray(segments[mine], np.int32),
                                     torch.int32)

        def batch_at(j):
            """This rank's rows of step ``j`` on the device (gathered from
            the staged stream by index under ``device_data``), shaped
            ``[feed, B/n, S+1]`` when a step has a leading block."""
            if X_dev is not None:
                idx = torch.arange(j * local_rows, (j + 1) * local_rows,
                                   device=self.device)
                block = X_dev.index_select(0, idx).long()
                seg = None if seg_dev is None else seg_dev.index_select(0,
                                                                        idx)
                if feed > 1:
                    block = block.reshape(feed, b, -1)
                    if seg is not None:
                        seg = seg.reshape(feed, b, -1)
                return self._window(block), (
                    None if seg is None else self._window(seg))
            return self._host_block(
                tokens, segments,
                mine[j * local_rows:(j + 1) * local_rows], feed, b)

        carry, losses, probes, rnd = (params, opt_state), [], [], 0
        tree, start = self._restore_or()
        if start:
            self._load_carry(carry, drop, tree)
            del tree
        # Profile rounds relative to the first executed round (resume
        # skips rnd <= start): one warm round, then profile_steps.
        prof, prof_start = None, start + 2
        capture = contextlib.ExitStack()
        try:
            for _ in range(self.num_epoch):
                for j in range(n_rows // rows_per_step):
                    rnd += 1
                    if rnd <= start:
                        continue
                    block, seg = batch_at(j)
                    if self.profile_dir and rnd == prof_start:
                        prof = capture.enter_context(profiling.trace(
                            self.profile_dir, lambda: "lm_trainer_rounds_"
                            f"{prof_start}-{rnd}.trace.json"))
                    carry, out = step(carry, block, drop, seg)
                    if self.probe_metrics:
                        out, probe = out
                        probes.append(probe["grad_norm"])
                    losses.append(out)
                    if (prof is not None
                            and rnd >= prof_start - 1 + self.profile_steps):
                        capture.close()
                        self.profile_path, prof = prof.last_path, None
                    self._checkpoint(lambda local=False: self._carry_tree(
                        carry, drop, full_params, local), rnd)
                    if eval_fn is not None and self.eval_every and \
                            rnd % self.eval_every == 0:
                        eval_fn(rnd)
            if prof is not None:  # a run shorter than the capture
                capture.close()
                self.profile_path, prof = prof.last_path, None
            elif self.profile_dir and rnd < prof_start:
                warnings.warn(
                    f"profile_dir is set but the run executed only "
                    f"{max(0, rnd - start)} round(s); the trace skips the "
                    f"first round and starts at round {prof_start - start} "
                    "— no profile was written. Train on more data or more "
                    "epochs to capture one.", stacklevel=3)
            if losses:
                self._checkpoint(lambda local=False: self._carry_tree(
                    carry, drop, full_params, local), rnd, final=True)
        finally:
            capture.close()  # an exception mid-capture
        if eval_fn is not None and not (
                self.eval_history and self.eval_history[-1][0] == rnd):
            eval_fn(-1)  # final state not already evaluated
        params, opt_state = carry
        params = full_params()
        # One device -> host transfer for the whole run; the losses are
        # the group's means (one all-reduce).  A run resumed past the
        # end executed none.
        self.history = []
        if losses:
            hist = _mean_over(torch.stack(losses).float(),
                              _token_axes(mesh))
            self.history = hist.tolist()
        self.probe_history = ([{"grad_norm": g}
                               for g in torch.stack(probes).tolist()]
                              if probes else [])
        self._ema_params = opt_state.ema
        if layout is not None and opt_state.ema is not None:
            self._ema_params = layout.gather(opt_state.ema)
        self.opt_state = opt_state
        self.residual_norm = residual_norm_of(opt_state)
        return params


class LoRATrainer(LMTrainer):
    """Fine-tune a frozen pretrained base with LoRA adapters under the
    ``LMTrainer`` contract (history, eval, shuffle, packing, device data,
    profiling).

    ``base_params``: the pretrained tree (``init_params`` layout, e.g.
    from ``load_lm``), on the trainer's device.  The trained state is the
    packed ``(adapters, base)`` pair, with the base copied at
    ``init_params``; the optimizer holds state for the adapter leaves only
    (``Optimizer.masked(lora_mask)``) and the loss merges a detached base
    inside the step, so the base copy comes out bit-identical.  ``train``
    returns the merged servable params; ``self.adapters`` keeps the raw
    adapters.  It checkpoints the packed ``(adapters, base)`` state
    and the adapters' optimizer state, as ``LMTrainer`` checkpoints its
    carry.
    """

    def __init__(self, cfg: tfm.TransformerConfig, base_params,
                 lora_rank: int = 8, lora_alpha: float = 16.0,
                 lora_targets=("wq", "wv"), **kw):
        if base_params is None:
            raise ValueError(
                "LoRATrainer needs the pretrained base_params (load_lm "
                "or a trained LMTrainer tree) — LoRA over a random base "
                "is a sign the wrong trainer was picked")
        self.lora = LoRAConfig(rank=lora_rank, alpha=lora_alpha,
                               targets=tuple(lora_targets))
        _validate(cfg, self.lora)
        if kw.get("ema_decay") is not None:
            raise ValueError(
                "ema_decay is not supported on LoRATrainer: the "
                "adapter-masked optimizer state cannot shadow the "
                "frozen base; serve the merged tree train() returns "
                "(or EMA-average adapters outside the trainer)")
        if kw.get("zero1") or kw.get("zero"):
            raise ValueError(
                "zero1/zero= is not supported on LoRATrainer: the "
                "masked packed (adapters, base) state keeps moments "
                "only for the small adapter leaves, so there is nothing "
                "worth sharding")
        if (kw.get("merge_rule", "mean") != "mean"
                or kw.get("sync_every", 1) != 1
                or kw.get("compress") is not None
                or kw.get("probe_metrics")):
            raise ValueError(
                "merge_rule/sync_every/compress/probe_metrics are not "
                "supported on LoRATrainer: the packed (adapters, base) "
                "gradient is small next to the base, so the exchange is "
                "never the bottleneck")
        super().__init__(cfg, **kw)
        check_on_device(base_params, self.device)
        self.optimizer = self.optimizer.masked(lora_mask)
        self._base = base_params
        self._loss_fn = make_lora_loss(cfg, self.lora)
        self.adapters = None

    def _merged(self, packed):
        adapters, base = packed
        with torch.no_grad():
            return lora_merge(base, adapters, self.cfg, self.lora)

    def _nll(self, packed, tokens, segment_ids=None):
        return tfm.lm_nll(self._merged(packed), tokens, self.cfg,
                          segment_ids=segment_ids)

    def init_params(self):
        adapters = lora_init(self.seed + 1, self.cfg, self.lora,
                             device=self.device)
        # A copy: the step updates the packed state in place, and the
        # caller's base must serve (or train again) untouched.
        base = tfm._map_leaves(lambda t: t.detach().clone(), self._base)
        return adapters, base

    def train(self, dataset, params=None, **kw):
        """Fine-tune over the token rows; returns the merged params
        (``lora_merge(base, self.adapters)``)."""
        if params is not None:
            raise ValueError(
                "LoRATrainer builds its own (adapters, base) state from "
                "the constructor's base_params; to resume, pass "
                "checkpoint_dir= with resume=True like any trainer")
        packed = super().train(dataset, **kw)
        self.adapters = packed[0]
        return self._merged(packed)
