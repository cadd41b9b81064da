"""Admission's padding: 100 x (1 - the real prompt tokens over the
bucket widths) summed over the window's ``serving.admit`` and
``serving.admit_chunk`` spans (their ``tokens`` and ``bucket``
fields)."""

from harness import spans

NAME, UNIT, MOVES = "admit_pad_share.serve", "%", "serve_tokens_per_s"


def read(run):
    found = [s["fields"] for s in spans.named(
        run.spans, "serving.admit", "serving.admit_chunk")
        if "tokens" in s["fields"]]
    if not found:
        return None
    return 100 * (1 - sum(f["tokens"] for f in found)
                  / sum(f["bucket"] for f in found))
