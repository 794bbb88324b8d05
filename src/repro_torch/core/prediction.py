"""DSA prediction path (paper §3.1).

    Q~ = (X P) W~q,   K~ = (X P) W~k,   S~ = Q~ K~^T

P is a constant sparse random projection (Achlioptas): entries
sqrt(3/k) * {-1, 0, +1} with probabilities {1/6, 2/3, 1/6}, shared by the
query and key branches; W~q, W~k are k x k; all three GEMMs run on
fake-quantized values.  One S~ per layer, shared across heads.

``predict_block_scores`` (pooled, the default) mean-pools Q~ over each
query block and max-pools the scores over each key block: block-level
scores without the token-level S~.  ``pooled=False`` is the
paper-faithful form: the full S~, max-pooled (``pool_block_scores``).
``mse_loss`` is the paper's Eq. 6 training term.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.quantization import fake_quant


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` after promoting both to their common dtype (jnp's rule:
    bf16 against f32 computes in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two-operand einsum with the same dtype promotion as ``mm``."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def init_projection(gen: torch.Generator, d: int, k: int, *, device,
                    dtype=torch.float32) -> torch.Tensor:
    """Achlioptas sparse random projection sqrt(3/k)*{-1,0,1}^{d x k}."""
    u = torch.rand((d, k), generator=gen, device=device)
    vals = torch.where(u < 1.0 / 6.0, -1.0,
                       torch.where(u < 2.0 / 6.0, 1.0, 0.0))
    return ((3.0 / k) ** 0.5 * vals).to(dtype)


def predictor_k(d_model: int, sigma: float) -> int:
    """Projection dim k = sigma * d, rounded to a multiple of 8 (>=8)."""
    return max(8, int(round(sigma * d_model / 8)) * 8)


def init_predictor(gen: torch.Generator, d_model: int, sigma: float, *,
                   device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    k = predictor_k(d_model, sigma)
    scale = 1.0 / k ** 0.5
    return {
        "p": init_projection(gen, d_model, k, device=device, dtype=dtype),
        "wq": (torch.randn((k, k), generator=gen, device=device)
               * scale).to(dtype),
        "wk": (torch.randn((k, k), generator=gen, device=device)
               * scale).to(dtype),
    }


def _project(params, x, bits):
    # P is constant: detached, so no gradient reaches it (the reference's
    # stop_gradient)
    return fake_quant(mm(x, params["p"].detach().to(x.dtype)), bits)


def predict_qk(params: Dict[str, torch.Tensor], x_q: torch.Tensor,
               x_kv: Optional[torch.Tensor], bits: int):
    """Return (Q~, K~): (B, Lq, k), (B, Lk, k)."""
    xp_q = _project(params, x_q, bits)
    xp_k = xp_q if x_kv is None else _project(params, x_kv, bits)
    q_t = mm(xp_q, fake_quant(params["wq"].to(x_q.dtype), bits))
    k_t = mm(xp_k, fake_quant(params["wk"].to(x_q.dtype), bits))
    return fake_quant(q_t, bits), fake_quant(k_t, bits)


def predict_scores(params, x_q, x_kv=None, *, bits: int = 4) -> torch.Tensor:
    """Token-granularity approximate scores S~ (B, Lq, Lk)."""
    q_t, k_t = predict_qk(params, x_q, x_kv, bits)
    return einsum("bqk,bsk->bqs", q_t, k_t)


def pool_block_scores(s_tilde: torch.Tensor, block_q: int,
                      block_k: int) -> torch.Tensor:
    """Max-pool token scores S~ (B, Lq, Lk) to (B, nQb, nKb) block
    scores."""
    b, lq, lk = s_tilde.shape
    if lq % block_q or lk % block_k:
        raise ValueError(f"lengths ({lq}, {lk}) are not multiples of the "
                         f"blocks ({block_q}, {block_k})")
    s = s_tilde.reshape(b, lq // block_q, block_q, lk // block_k, block_k)
    return s.amax(dim=(2, 4))


def predict_block_scores(params, x_q, x_kv=None, *, bits: int = 4,
                         block_q: int = 128, block_k: int = 128,
                         pooled: bool = True) -> torch.Tensor:
    """Block-granularity approximate scores (B, nQb, nKb): pooled (Q~
    mean-pooled over each query block before the score product) or, with
    ``pooled=False``, the full S~ max-pooled."""
    if not pooled:
        return pool_block_scores(
            predict_scores(params, x_q, x_kv, bits=bits), block_q, block_k)
    q_t, k_t = predict_qk(params, x_q, x_kv, bits)
    b, lq, k = q_t.shape
    lk = k_t.shape[1]
    if lq % block_q or lk % block_k:
        raise ValueError(f"lengths ({lq}, {lk}) are not multiples of the "
                         f"blocks ({block_q}, {block_k})")
    q_blk = q_t.reshape(b, lq // block_q, block_q, k).mean(dim=2)
    s = einsum("bqk,bsk->bqs", q_blk, k_t)               # (B, nQb, Lk)
    s = s.reshape(b, lq // block_q, lk // block_k, block_k)
    return s.amax(dim=-1)


def mse_loss(s: torch.Tensor, s_tilde: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 6: the mean squared error between S and S~, in f32 (a
    mean over every position; lambda absorbs the constant)."""
    return ((s.float() - s_tilde.float()) ** 2).mean()
