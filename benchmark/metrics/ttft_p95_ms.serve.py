"""Time to first token, 95th percentile over every request sent in the
window, from the client's send to the return of the step that brought
its first token (host clock)."""

NAME, UNIT, MOVES = "ttft_p95_ms.serve", "ms", "serve_tokens_per_s"


def read(run):
    return run.counters.get("serve.ttft_p95_ms")
