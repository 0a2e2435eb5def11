"""The device a tool runs on: what every tool's `--device` resolves to."""
from __future__ import annotations

import torch


def pick_device(name: str) -> torch.device:
    """The device asked for; a card that is not there raises, so that no
    tool carries on on the CPU without being asked to."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: torch.cuda.is_available() is "
                           "false; pass --device cpu to run on the CPU")
    return dev
