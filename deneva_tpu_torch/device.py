"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; asking for CUDA on a host
    without it raises (never a quiet fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was asked for but torch.cuda.is_available() "
                "is false; pass device='cpu' to run on the host")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
