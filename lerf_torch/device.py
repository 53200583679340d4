"""Device resolution: ``cuda`` by default, the CPU only when asked for."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"`` / ``"cuda"`` / ``"cuda:1"`` / a
    :class:`torch.device` pass through.

    Raises if a CUDA device is asked for and none is visible — the port
    never carries on silently on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (CLI: --platform cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def concrete_device(device=None) -> torch.device:
    """:func:`resolve_device`, a card named by its index (``cuda`` →
    ``cuda:<current>``), as a tensor on it reports its ``device``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
