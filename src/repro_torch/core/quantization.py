"""Fake quantization for the DSA prediction path (paper §3.1, Table 3).

Symmetric per-row fake-quant: the prediction GEMMs are computed on values
rounded to ``bits`` bits and scaled back.  ``bits >= 32`` is a no-op.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch


def quantize(x: torch.Tensor, bits: int, axis: int = -1) -> torch.Tensor:
    """Symmetric uniform fake-quant along ``axis`` (per-row scale)."""
    if bits >= 32:
        return x
    qmax = 2.0 ** (bits - 1) - 1.0
    scale = x.abs().amax(dim=axis, keepdim=True) / qmax
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.round(x / scale)
    q = torch.clamp(q, -qmax - 1, qmax)
    return q * scale


def fake_quant(x: torch.Tensor, bits: int, axis: int = -1) -> torch.Tensor:
    """Straight-through fake quant: forward quantized, identity gradient."""
    if bits >= 32:
        return x
    return x + (quantize(x, bits, axis=axis) - x).detach()
