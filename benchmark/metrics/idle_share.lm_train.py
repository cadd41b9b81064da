"""The share of the traced part of the window in which no operation ran
on the card, from the profiler's trace of the LM training cell."""

from harness import kernels

NAME, UNIT, MOVES = "idle_share.lm_train", "%", "train_tokens_per_s"


def read(run):
    if run.counters.get("kind") != "lm_train":
        return None
    return kernels.idle_share(run)
