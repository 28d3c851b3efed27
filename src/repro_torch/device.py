"""Where the port's entry points run: on the card unless the caller asks
for the CPU.  Nothing carries on on the CPU when it finds no card."""

from __future__ import annotations

import torch


def resolve(device: str | torch.device, who: str) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names the card and
    there is none, or names anything but the card or the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{who} runs on cuda or cpu, not {device}")
    return device
