"""The share of the traced part of the window in which no operation ran
on the card, from the profiler's trace of the serving cell."""

from harness import kernels

NAME, UNIT, MOVES = "idle_share.serve", "%", "serve_tokens_per_s"


def read(run):
    if run.counters.get("kind") != "serve":
        return None
    return kernels.idle_share(run)
