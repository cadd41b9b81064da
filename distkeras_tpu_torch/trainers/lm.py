"""LMTrainer on one GPU: the flagship LM under the trainer-family API.

Counterpart of ``distkeras_tpu/trainers/lm.py::LMTrainer``, one-device
subset: ``LMTrainer(cfg, ...).train(tokens) -> params`` with ``history``,
``eval_history``, ``training_time``, ``probe_history`` and
``ema_params``.  The data order is the reference's, bit for bit: the
shuffle is ``np.random.default_rng(seed).permutation``, each step takes
the next ``batch_size * grad_accum`` rows and the remainder is dropped,
and eval chunks of packed rows are weighted by their valid-target count.

Dataset contract: token rows ``[N, seq_len + 1]`` (inputs plus the
shifted targets, as ``lm_loss`` expects), with optional packed
``segments`` of the same shape (``data.packing.pack_documents``).

Runs on the card unless ``device="cpu"``.  The parallel, checkpoint and
profile knobs of the reference raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from distkeras_tpu_torch.models import transformer as tfm
from distkeras_tpu_torch.trainers.optim import LM_NAMES, Optimizer
from distkeras_tpu_torch.utils.device import check_on_device, resolve_device

# Reference knobs not ported yet: name -> (default, ROADMAP item).
_UNPORTED = {
    "mesh": (None, "A7"), "rules": (None, "A7"), "microbatches": (None, "A7"),
    "fsdp": (False, "A7"), "zero": (None, "A7"), "zero1": (False, "A7"),
    "zero1_bucket_mb": (None, "A7"), "zero_bucket_mb": (None, "A7"),
    "device_data": (False, "A7"), "merge_rule": ("mean", "A7"),
    "sync_every": (1, "A7"), "compress": (None, "A7"),
    "topk_frac": (0.01, "A7"), "checkpoint_dir": (None, "A8"),
    "checkpoint_every": (0, "A8"), "max_checkpoints": (3, "A8"),
    "resume": (False, "A8"), "checkpoint_backend": ("auto", "A8"),
    "profile_dir": (None, "A4"), "profile_steps": (3, "A4"),
}


def nll_to_perplexity(mean_nll: float) -> float:
    """exp(mean NLL) with the reference's overflow guard."""
    return math.exp(mean_nll) if mean_nll < 700 else float("inf")


def _valid_targets(seg) -> int:
    """Trainable targets of packed rows: the target continues its
    input's (nonzero) segment."""
    return int(((seg[:, 1:] == seg[:, :-1]) & (seg[:, :-1] != 0)).sum())


class LMTrainer:
    """Train a causal transformer LM on one device.

    ``optimizer`` is one of ``adam`` / ``adamw`` / ``sgd`` (optax's
    defaults, see ``trainers.optim``); ``learning_rate`` may be a schedule
    of the step count.  ``grad_accum`` microbatches of ``batch_size`` rows
    make one step; ``probe_metrics`` records the global gradient norm per
    step (``probe_history``); ``ema_decay`` keeps an EMA of the weights
    (``ema_params``).  Dropout (``cfg.dropout > 0``) draws its masks from
    one generator seeded with ``seed + 0x5eed``.
    """

    def __init__(self, cfg: tfm.TransformerConfig, optimizer: str = "adamw",
                 learning_rate=3e-4, weight_decay: float | None = None,
                 batch_size: int = 8, num_epoch: int = 1,
                 grad_accum: int = 1, grad_clip_norm: float | None = None,
                 probe_metrics: bool = False, seed: int = 0,
                 shuffle: bool = False, eval_every: int = 0,
                 ema_decay: float | None = None, device=None, **unported):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"LMTrainer got an unexpected keyword "
                                f"argument {name!r}")
            default, item = _UNPORTED[name]
            if value != default:
                raise NotImplementedError(
                    f"LMTrainer({name}=...) is not ported yet (ROADMAP "
                    f"{item}); the port trains on one device")
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if eval_every < 0:
            raise ValueError(f"eval_every must be >= 0, got {eval_every}")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if optimizer not in LM_NAMES:
            raise ValueError(f"unknown optimizer {optimizer!r}; known: "
                             f"{sorted(LM_NAMES)}")
        self.cfg = cfg
        self.optimizer = Optimizer(optimizer, learning_rate, weight_decay,
                                   grad_clip_norm, ema_decay)
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.num_epoch = num_epoch
        self.grad_accum = grad_accum
        self.probe_metrics = probe_metrics
        self.seed = seed
        self.shuffle = shuffle
        self.eval_every = eval_every
        self.history: list[float] = []
        # [(round, {"loss", "perplexity"})]; round -1 = the final state.
        self.eval_history: list[tuple[int, dict]] = []
        self.probe_history: list[dict] = []
        self.training_time = 0.0
        self._ema_params = None

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

    def _rows(self, a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device,
                                                            dtype)

    def train(self, tokens, params=None, eval_tokens=None, segments=None,
              eval_segments=None):
        """Train over the token rows; returns the trained params (a new
        dict: the caller's ``params`` are not modified).

        ``eval_tokens [M, seq+1]`` (with ``eval_every``) runs a held-out
        NLL / perplexity evaluation every ``eval_every`` steps and once at
        the end (round -1) into ``eval_history``, in ``batch_size`` chunks
        (a remainder of up to ``batch_size - 1`` rows is dropped).
        ``segments`` (and ``eval_segments``): packed-sequence ids aligned
        with the rows.
        """
        tokens = np.asarray(tokens)
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
            perm = np.random.default_rng(self.seed).permutation(len(tokens))
            tokens = tokens[perm]
            if segments is not None:
                segments = segments[perm]
        self.eval_history = []
        if self.eval_every and eval_tokens is None:
            raise ValueError("eval_every is set but train() got no "
                             "eval_tokens")
        bs = self.batch_size
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
        rows_per_step = bs * self.grad_accum
        n_rows = len(tokens) - (len(tokens) % rows_per_step)
        if not n_rows:
            raise ValueError(
                f"dataset has {len(tokens)} rows; one step needs "
                f"{rows_per_step} (batch_size x grad_accum)")

        t0 = time.perf_counter()
        if params is None:
            params = self.init_params()
        else:
            check_on_device(params, self.device)
            params = tfm._map_leaves(lambda p: p.detach().clone(), params)
        opt_state = self.optimizer.init(params)
        step = tfm.make_train_step(self.cfg, self.optimizer,
                                   grad_accum=self.grad_accum,
                                   probe=self.probe_metrics)
        drop = None
        if self.cfg.dropout > 0:
            drop = torch.Generator(self.device).manual_seed(
                self.seed + 0x5eed)

        eval_fn = None
        if eval_tokens is not None:
            n_eval = len(eval_tokens) - (len(eval_tokens) % bs)
            chunks = [self._rows(eval_tokens[j:j + bs], torch.long)
                      for j in range(0, n_eval, bs)]
            seg_chunks = weights = None
            if eval_segments is not None:
                eval_segments = np.asarray(eval_segments)
                seg_chunks = [self._rows(eval_segments[j:j + bs],
                                         torch.int32)
                              for j in range(0, n_eval, bs)]
                # Packed chunks carry different valid-target counts: each
                # chunk's mean NLL is weighted by its count.
                weights = [_valid_targets(eval_segments[j:j + bs])
                           for j in range(0, n_eval, bs)]

            @torch.no_grad()
            def eval_fn(rnd):
                if seg_chunks is None:
                    mean = sum(float(tfm.lm_nll(params, c, self.cfg))
                               for c in chunks) / len(chunks)
                else:
                    tot = sum(w * float(tfm.lm_nll(params, c, self.cfg,
                                                   segment_ids=sc))
                              for c, sc, w in zip(chunks, seg_chunks,
                                                  weights))
                    mean = tot / max(sum(weights), 1)
                self.eval_history.append(
                    (rnd, {"loss": mean,
                           "perplexity": nll_to_perplexity(mean)}))

        carry, losses, probes, rnd = (params, opt_state), [], [], 0
        for _ in range(self.num_epoch):
            for i in range(0, n_rows, rows_per_step):
                rnd += 1
                block = self._rows(tokens[i:i + rows_per_step], torch.long)
                seg = None
                if segments is not None:
                    seg = self._rows(segments[i:i + rows_per_step],
                                     torch.int32)
                if self.grad_accum > 1:
                    block = block.reshape(self.grad_accum, bs, -1)
                    if seg is not None:
                        seg = seg.reshape(self.grad_accum, bs, -1)
                carry, out = step(carry, block, drop, seg)
                if self.probe_metrics:
                    out, probe = out
                    probes.append(probe["grad_norm"])
                losses.append(out)
                if eval_fn is not None and self.eval_every and \
                        rnd % self.eval_every == 0:
                    eval_fn(rnd)
        if eval_fn is not None and not (
                self.eval_history and self.eval_history[-1][0] == rnd):
            eval_fn(-1)  # final state not already evaluated
        params, opt_state = carry
        # One device -> host transfer for the whole run.
        self.history = torch.stack(losses).tolist()
        self.probe_history = ([{"grad_norm": g}
                               for g in torch.stack(probes).tolist()]
                              if probes else [])
        self._ema_params = opt_state.ema
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.training_time = time.perf_counter() - t0
        return params

