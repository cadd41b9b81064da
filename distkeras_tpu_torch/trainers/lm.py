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
``device="cpu"``.  The parallel and checkpoint knobs of the reference
raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
import os
import time
import warnings

import numpy as np
import torch

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models import transformer as tfm
from distkeras_tpu_torch.native import gather_rows
from distkeras_tpu_torch.trainers.optim import LM_NAMES, Optimizer
from distkeras_tpu_torch.utils.device import check_on_device, resolve_device

# Reference knobs not ported yet: name -> (default, ROADMAP item).
_UNPORTED = {
    "mesh": (None, "A7"), "rules": (None, "A7"), "microbatches": (None, "A7"),
    "fsdp": (False, "A7"), "zero": (None, "A7"), "zero1": (False, "A7"),
    "zero1_bucket_mb": (None, "A7"), "zero_bucket_mb": (None, "A7"),
    "merge_rule": ("mean", "A7"),
    "sync_every": (1, "A7"), "compress": (None, "A7"),
    "topk_frac": (0.01, "A7"), "checkpoint_dir": (None, "A8"),
    "checkpoint_every": (0, "A8"), "max_checkpoints": (3, "A8"),
    "resume": (False, "A8"), "checkpoint_backend": ("auto", "A8"),
}

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

    ``device_data=True`` stages the (shuffled) int32 rows on the device
    once, in consumption order, behind an HBM guard, and each step
    gathers its rows there by index: the reference's one-device
    ``_stage_stream``, the same data order as streaming.
    ``profile_dir`` traces optimizer rounds ``[2, 2 + profile_steps)``
    (round 1 pays the first-call set-up) with ``torch.profiler`` and
    writes a chrome trace there (``profile_path``).
    """

    def __init__(self, cfg: tfm.TransformerConfig, optimizer: str = "adamw",
                 learning_rate=3e-4, weight_decay: float | None = None,
                 batch_size: int = 8, num_epoch: int = 1,
                 grad_accum: int = 1, grad_clip_norm: float | None = None,
                 probe_metrics: bool = False, seed: int = 0,
                 shuffle: bool = False, eval_every: int = 0,
                 ema_decay: float | None = None, device_data: bool = False,
                 tokens_col: str = "tokens", profile_dir: str | None = None,
                 profile_steps: int = 3, device=None, **unported):
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
                "host instead", stacklevel=3)

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

            if self.profile_dir and self.eval_every:
                # Warm the eval call, so an eval round inside the capture
                # records its steady run, not its first-call set-up.
                with torch.no_grad():
                    tfm.lm_nll(params, chunks[0], self.cfg,
                               segment_ids=None if seg_chunks is None
                               else seg_chunks[0])

        X_dev = seg_dev = None
        if self.device_data:
            self._guard_staged_bytes(n_rows, tokens.shape[1],
                                     segments is not None)
            X_dev = self._rows(np.asarray(tokens[:n_rows], np.int32),
                               torch.int32)
            if segments is not None:
                seg_dev = self._rows(np.asarray(segments[:n_rows], np.int32),
                                     torch.int32)

        def batch_at(i):
            """Rows ``[i, i + rows_per_step)`` of the stream on the device
            (gathered from the staged stream by index under
            ``device_data``), shaped for grad_accum."""
            if X_dev is not None:
                idx = torch.arange(i, i + rows_per_step, device=self.device)
                block = X_dev.index_select(0, idx).long()
                seg = None if seg_dev is None else seg_dev.index_select(0,
                                                                        idx)
            else:
                block = self._rows(tokens[i:i + rows_per_step], torch.long)
                seg = None
                if segments is not None:
                    seg = self._rows(segments[i:i + rows_per_step],
                                     torch.int32)
            if self.grad_accum > 1:
                block = block.reshape(self.grad_accum, bs, -1)
                if seg is not None:
                    seg = seg.reshape(self.grad_accum, bs, -1)
            return block, seg

        carry, losses, probes, rnd = (params, opt_state), [], [], 0
        prof, prof_start = None, 2
        try:
            for _ in range(self.num_epoch):
                for i in range(0, n_rows, rows_per_step):
                    rnd += 1
                    block, seg = batch_at(i)
                    if self.profile_dir and rnd == prof_start:
                        prof = self._start_profile()
                    carry, out = step(carry, block, drop, seg)
                    if self.probe_metrics:
                        out, probe = out
                        probes.append(probe["grad_norm"])
                    losses.append(out)
                    if (prof is not None
                            and rnd >= prof_start - 1 + self.profile_steps):
                        self._stop_profile(prof, prof_start, rnd)
                        prof = None
                    if eval_fn is not None and self.eval_every and \
                            rnd % self.eval_every == 0:
                        eval_fn(rnd)
            if prof is not None:  # a run shorter than the capture
                self._stop_profile(prof, prof_start, rnd)
                prof = None
            elif self.profile_dir and rnd < prof_start:
                warnings.warn(
                    f"profile_dir is set but the run executed only {rnd} "
                    f"round(s); the trace skips the first round and starts "
                    f"at round {prof_start} — no profile was written. "
                    "Train on more data or more epochs to capture one.",
                    stacklevel=2)
        finally:
            if prof is not None:  # an exception mid-capture
                prof.__exit__(None, None, None)
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

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof, first: int, last: int) -> None:
        """Close the capture once its device work is done and write the
        chrome trace of rounds ``[first, last]`` into ``profile_dir``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir,
                            f"lm_trainer_rounds_{first}-{last}.trace.json")
        prof.export_chrome_trace(path)
        self.profile_path = path
