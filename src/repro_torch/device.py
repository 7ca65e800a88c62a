"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA card; raise when there is none.

    The port never carries on silently on the CPU: a caller that wants the
    CPU (the tests, a host-side reference run) asks for it by name.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' explicitly "
                "to run the port on the host")
        return torch.device("cuda")
    return torch.device(device)
