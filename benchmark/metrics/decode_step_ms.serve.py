"""The serving engine's decode: the total duration of the window's
``serving.step`` spans over the decode steps they ran (each step
advances every lane by one token)."""

NAME, UNIT, MOVES = "decode_step_ms.serve", "ms", "serve_tokens_per_s"


def read(run):
    steps = [s for s in run.spans if s["name"] == "serving.step"]
    if not steps:
        return None
    ms = sum(s["dur"] for s in steps) * 1e3
    return ms / sum(s["fields"].get("n", 1) for s in steps)
