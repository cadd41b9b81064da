"""The yardstick's arithmetic against hand counts."""

from __future__ import annotations

import bench_tiny  # noqa: F401  (puts the benchmark on the path)
import pytest

from harness import reckon

FLAGSHIP = {"vocab_size": 32768, "d_model": 1024, "n_heads": 8,
            "n_layers": 8, "d_ff": 4096}


def test_pairs():
    assert reckon.causal_pairs(4) == 1 + 2 + 3 + 4
    assert reckon.attention_pairs(4, 6, causal=False) == 24
    assert reckon.attention_pairs(4, 4, causal=True) == 10


@pytest.mark.parametrize("causal,pairs", [(True, 10), (False, 16)])
def test_attention_call_counts(causal, pairs):
    # b=1, l=4, h=1, d=2, f32: q, k, v, o are 32 B each; a row of lse
    # or delta is 16 B.
    flops, nbytes = reckon.attention_call("fwd", 1, 4, 1, 2, causal,
                                          "float32")
    assert (flops, nbytes) == (4 * 2 * pairs, 4 * 32 + 16)
    flops, nbytes = reckon.attention_call("dq", 1, 4, 1, 2, causal,
                                          "float32")
    assert (flops, nbytes) == (6 * 2 * pairs, 5 * 32 + 2 * 16)
    flops, nbytes = reckon.attention_call("dkv", 1, 4, 1, 2, causal,
                                          "float32")
    assert (flops, nbytes) == (8 * 2 * pairs, 6 * 32 + 2 * 16)
    flops, nbytes = reckon.attention_call("fwd", 1, 4, 1, 2, causal,
                                          "bfloat16")
    assert nbytes == 4 * 16 + 16


def test_attention_bounds_match_the_kernel_table():
    # PERF.md's kernel table: f32 [8, 4096, 8, 128] causal bounds.
    for kind, ms in (("fwd", 1.666), ("dq", 2.500), ("dkv", 3.333)):
        s, by = reckon.attention_bound_s(kind, 8, 4096, 8, 128, True,
                                         "float32")
        assert by == "flops"
        assert s * 1e3 == pytest.approx(ms, abs=6e-4)
    with pytest.raises(ValueError):
        reckon.attention_call("bwd", 1, 4, 1, 2, True, "float32")


def test_lm_flops():
    d, f, layers, v = 1024, 4096, 8, 32768
    n = layers * (4 * d * d + 2 * d * f) + v * d
    assert reckon.lm_matmul_params(FLAGSHIP) == n == 134_217_728
    assert reckon.lm_train_flops(FLAGSHIP, 8, 4096) == (
        6 * n * 8 * 4096 + 3 * 4 * d * layers * 8 * 4096 * 4097 // 2)
    tiny = {"vocab_size": 3, "d_model": 2, "n_heads": 1, "n_layers": 1,
            "d_ff": 4}
    n_tiny = 4 * 2 * 2 + 2 * 2 * 4 + 3 * 2
    # Two tokens at positions 5 and 6 see 6 and 7 keys.
    assert reckon.lm_forward_flops(tiny, 5, 2) == (
        2 * n_tiny * 2 + 4 * 2 * 1 * (6 + 7))
