"""The LM training step's share of the card's f32 peak: the model FLOPs
of the window's steps (6 N a token plus causal attention, recomputation
not counted) over the window's seconds x 67 TFLOP/s, the f32 rate
without tensor cores, which is the precision of this step's products
(TF32 off)."""

from harness import reckon

NAME, UNIT, MOVES = "mfu.lm_train", "%", "train_tokens_per_s"


def read(run):
    c = run.counters
    if "lm_train.model_flops" not in c:
        return None
    return 100 * c["lm_train.model_flops"] / (
        c["window_s"] * reckon.PEAK_FLOPS["float32"])
