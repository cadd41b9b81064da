"""The port's device rule: CUDA by default, the CPU only when asked."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; with no card that raises instead of
    falling back to the CPU silently (pass ``device="cpu"`` for that)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on the GPU by "
                "default — pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def check_on_device(params, device: torch.device) -> None:
    """Params must already live on ``device`` (moving a model per call
    would hide a full copy of the weights)."""
    have = params["tok_emb"].device
    if have.type != device.type or (device.index is not None
                                    and have != device):
        raise ValueError(
            f"params live on {have} but the call runs on {device}: load "
            "them there (params_from_numpy / load_lm with device=...)")
