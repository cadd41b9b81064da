"""The flash-attention forward kernel's share of its roofline in the
LM training step: per launch, the least time the call's shapes need
(max of FLOPs over the 3xTF32 peak and bytes over the HBM rate, counted
by ``harness/reckon.py``), summed over the traced launches, over their
summed device time."""

from harness import kernels

NAME, UNIT, MOVES = "flash_fwd_roofline.train", "%", "train_tokens_per_s"
KERNELS = {"fwd": ("flash_fwd",)}


def read(run):
    return kernels.roofline_share(run, "lm_train.attention", KERNELS)
