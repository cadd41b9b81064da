"""The serving engine's share of the card's bf16 peak: the model FLOPs
of the prompt tokens admitted and the tokens decoded in the window (2 N
a token plus attention over the keys each query sees), over the
window's seconds x 989 TFLOP/s."""

from harness import reckon

NAME, UNIT, MOVES = "mfu.serve", "%", "serve_tokens_per_s"


def read(run):
    c = run.counters
    if "serve.model_flops" not in c:
        return None
    return 100 * c["serve.model_flops"] / (
        c["window_s"] * reckon.PEAK_FLOPS["bfloat16"])
