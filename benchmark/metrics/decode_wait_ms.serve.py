"""The host waiting for the card in the serving engine's decode: the
total duration of the window's ``serving.readback`` spans (inside
``serving.step``: the copy of a window's tokens to the host, which
waits for the window's device work) over the decode steps they ran."""

from harness import spans

NAME, UNIT, MOVES = "decode_wait_ms.serve", "ms", "serve_tokens_per_s"


def read(run):
    return spans.host_ms_a_step(run.spans, "serving.readback")
