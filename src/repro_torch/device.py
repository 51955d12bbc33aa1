"""The port's device rule: entry points run on the CUDA card unless the
caller asks for another device, and never fall back silently."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as given (``"cuda"`` pinned to the current card's index),
    else the current CUDA card.  Raises when no device is given and CUDA
    is absent: a run meant for the card must not quietly measure the
    CPU."""
    if device is not None:
        d = torch.device(device)
        if d.type == "cuda" and d.index is None and torch.cuda.is_available():
            # the card current now, by index: a thread of its own (the
            # staging producer) starts on card 0 whatever this one uses
            d = torch.device("cuda", torch.cuda.current_device())
        return d
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
