"""Default-device resolution.

Every entry point of the port runs on ``cuda`` unless its caller passes
``device="cpu"``.  Where CUDA is missing and the caller did not ask for
the CPU, :func:`resolve_device` raises: the port never falls back to the
CPU on its own."""
from __future__ import annotations

from typing import Optional, Union

import torch

def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the CUDA card, and raises without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available")
    return dev

