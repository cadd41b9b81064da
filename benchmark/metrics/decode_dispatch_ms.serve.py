"""The host enqueueing the serving engine's decode windows: the total
duration of the window's ``serving.dispatch`` spans (inside
``serving.step``) over the decode steps they ran."""

from harness import spans

NAME, UNIT, MOVES = "decode_dispatch_ms.serve", "ms", "serve_tokens_per_s"


def read(run):
    return spans.host_ms_a_step(run.spans, "serving.dispatch")
