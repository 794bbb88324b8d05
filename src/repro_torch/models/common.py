"""Shared model primitives: initializer, RMS norm, RoPE."""
from __future__ import annotations

import torch


def dense_init(gen: torch.Generator, shape, scale: float = 1.0, *, device,
               dtype=torch.float32) -> torch.Tensor:
    fan_in = shape[0] if len(shape) > 1 else 1
    std = scale / (fan_in ** 0.5)
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """Normalise in f32, cast back, then scale by gamma in the working
    dtype (the reference's order of operations)."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding on interleaved pairs (x[..., ::2], x[..., 1::2]),
    not the half-split layout.  x: (B, S, H, hd); positions: (S,) or
    (B, S)."""
    b, s, h, hd = x.shape
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                    device=x.device) / hd)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                  # (B,S,hd/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., ::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(b, s, h, hd)
