"""Device selection for the port's entry points.

Builders and engines put their tensors on the CUDA card unless the caller
names another device; with no card and no ``device=`` they raise, so a
run never drops to the host without being asked to.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the host")
        return torch.device("cuda")
    return torch.device(device)
