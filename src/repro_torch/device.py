"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  ``cuda`` is the default of
    every entry point; when no card is present that is an error, never
    a silent switch to the CPU — the caller must ask for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this machine; pass device='cpu' "
                "explicitly to run the port on the CPU")
        if dev.index is None:       # "cuda" names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
