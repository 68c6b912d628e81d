"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device``.  The default is the card:
``None`` means ``"cuda"``, and asking for CUDA where there is none raises
instead of quietly running on the CPU.  Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev
