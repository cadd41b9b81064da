"""The comparisons that decide ``correct``.

A training step is judged by the gap between the program's norm of a
leaf and the reference's, not by the norm of their difference, taken
against the reference's norm of that leaf or of the median leaf,
whichever is larger (some gradients are all but zero); the worst leaf
is the number compared.
"""

from __future__ import annotations

import statistics

# Leaves whose reference gradient is this far under the median leaf's
# move by round-off alone under Adam and are left out of the change.
STILL_LEAF = 1e-3


def worst_leaf_gap(prog: dict, ref: dict, leaves=None) -> float:
    """max over ``leaves`` (default all) of |prog - ref| / max(ref,
    median of ref)."""
    med = statistics.median(ref.values())
    names = list(ref) if leaves is None else list(leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in names)


def median_leaf_diff(prog: dict, ref: dict, leaves) -> float:
    """The median over ``leaves`` of ||prog - ref|| / max(||ref||, the
    median leaf's ||ref||), from the tensors themselves: rounding that
    is unbiased cancels in a leaf's norm but not in this."""
    norms = {k: float(v.norm()) for k, v in ref.items()}
    med = statistics.median(norms.values())
    return statistics.median(
        float((prog[k].to(ref[k].device).double() - ref[k].double()).norm())
        / max(norms[k], med) for k in leaves)


def moving_leaves(ref_grad: dict) -> list:
    """The leaves the reference's first gradient moves: those whose
    gradient norm is at least a thousandth of the median leaf's."""
    med = statistics.median(ref_grad.values())
    return [k for k, g in ref_grad.items() if g >= STILL_LEAF * med]


def loss_gap(prog: list, ref: list) -> float:
    """The largest absolute gap between the step losses, in nats."""
    return max(abs(float(a) - float(b)) for a, b in zip(prog, ref))


def training_numbers(ref_readings, readings) -> dict:
    """The numbers a training cell compares, from ``(losses, first
    gradient norms by leaf, change norms by leaf, first gradient by
    leaf)`` of the side judged and of the reference."""
    r_loss, r_g1, r_change, r_first = ref_readings
    loss, g1, change, first = readings
    moving = moving_leaves(r_g1)
    return {"loss_gap": loss_gap(loss, r_loss),
            "grad1_gap": worst_leaf_gap(g1, r_g1, moving),
            "grad1_median_diff": median_leaf_diff(first, r_first, moving),
            "change3_gap": worst_leaf_gap(change, r_change, moving)}
