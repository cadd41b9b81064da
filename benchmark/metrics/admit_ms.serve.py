"""Admission: the mean duration of the window's ``serving.admit`` spans
(one bucket-padded prefill into one lane)."""

NAME, UNIT, MOVES = "admit_ms.serve", "ms", "serve_tokens_per_s"


def read(run):
    spans = [s for s in run.spans if s["name"] == "serving.admit"]
    if not spans:
        return None
    return 1e3 * sum(s["dur"] for s in spans) / len(spans)
