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


# -- storage quantization (mixed-precision serving) ---------------------------
#
# Unlike ``quantize`` above (fake-quant, returning f32 scaled back), these
# return the NARROW values and an f32 per-row scale, so caches are held at
# one byte an element and dequantized only where the arithmetic needs full
# precision (the top-k reduction, the attend over gathered rows).
# Symmetric, no zero point: an all-zero row keeps scale 0.0, so dequant
# gives exact zeros.  The operations are the reference's, in its order.

QUANT_STORE_DTYPES = ("int8", "fp8")
_QMAX = {"int8": 127.0, "fp8": 448.0}
STORE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def quant_store(x: torch.Tensor, axis: int = -1, dtype: str = "int8"):
    """Quantize ``x`` for storage: returns ``(q, scale)``, ``q`` int8 or
    float8_e4m3fn and ``scale`` f32 with ``axis`` removed."""
    if dtype not in _QMAX:
        raise ValueError(f"quant_store dtype {dtype!r} not in "
                         f"{QUANT_STORE_DTYPES}")
    x = x.float()
    qmax = _QMAX[dtype]
    amax = x.abs().amax(dim=axis, keepdim=True)
    scale = amax / qmax
    inv = torch.where(scale == 0, 0.0,
                      1.0 / torch.where(scale == 0, 1.0, scale))
    y = x * inv
    if dtype == "int8":
        q = torch.round(y).clamp(-128, 127).to(torch.int8)
    else:
        q = y.clamp(-qmax, qmax).to(torch.float8_e4m3fn)
    return q, scale.squeeze(axis)


def dequant(q: torch.Tensor, scale: torch.Tensor,
            axis: int = -1) -> torch.Tensor:
    """Invert ``quant_store``: ``scale`` is broadcast back over ``axis``."""
    return q.float() * scale.float().unsqueeze(axis)


def raw(t: torch.Tensor) -> torch.Tensor:
    """The tensor to gather, scatter or zero-fill in place of ``t``: a
    uint8 view of an fp8 tensor (CUDA builds of PyTorch lack fp8 kernels
    for indexing and ``where``), ``t`` itself otherwise."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def from_raw(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``r``, computed on ``raw(t)``, in ``t``'s dtype: viewed back for
    fp8 only, since ``Tensor.view(dtype)`` carries no gradient and would
    cut autograd on a full-width tensor."""
    return r.view(t.dtype) if r.dtype != t.dtype else r


def take(t: torch.Tensor, *index) -> torch.Tensor:
    """``t[index]`` through ``raw``: a gather that keeps ``t``'s dtype."""
    return from_raw(raw(t)[index], t)


def take_rows(t: torch.Tensor, scale, *index) -> torch.Tensor:
    """``t[index]`` in f32: dequantized by ``scale[index]`` where a scale
    is given (an int8/fp8 cache), cast otherwise."""
    g = take(t, *index)
    return g.float() if scale is None else dequant(g, scale[index])
