"""The few device calls the drivers make, so that the tests can drive
a run's logic on the CPU at a tiny size (the harness itself refuses to
run without a card)."""

from __future__ import annotations


def sync(device: str) -> None:
    import torch

    if device != "cpu":
        torch.cuda.synchronize()


def reset_peak(device: str) -> None:
    import torch

    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def peak(device: str) -> int:
    import torch

    return 0 if device == "cpu" else int(torch.cuda.max_memory_allocated())


def free(device: str) -> None:
    import gc

    import torch

    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()


class _Done:
    def synchronize(self) -> None:
        pass


def marker(device: str):
    """An event recorded on the current stream (the CPU's work is done
    when the call returns)."""
    import torch

    if device == "cpu":
        return _Done()
    ev = torch.cuda.Event()
    ev.record()
    return ev
