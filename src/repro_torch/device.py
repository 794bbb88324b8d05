"""Device choice for the port's entry points.

Entry points (``init_model``, ``Engine``, ``launch/serve.py``) run on the
card unless the caller names another device.  Without a card they raise:
they never fall back to the CPU on their own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card; raises when CUDA is not available.  A
    card without an index gets the current one, so that it compares equal
    to the device of the tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the port's "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
