"""The flash-attention backward kernels' (dQ, then dK and dV) share of
their roofline in the LM training step: per launch, the least time the
call's shapes need, summed over the traced launches of both kernels,
over their summed device time."""

from harness import kernels

NAME, UNIT, MOVES = "flash_bwd_roofline.train", "%", "train_tokens_per_s"
KERNELS = {"dq": ("flash_bwd_dq",), "dkv": ("flash_bwd_dkv",)}


def read(run):
    return kernels.roofline_share(run, "lm_train.attention", KERNELS)
