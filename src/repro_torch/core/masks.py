"""Sparse-pattern construction (paper §3.1, §5.2).

Token-granularity row top-k masks (the paper's fine-grained pattern) and
the block index lists the block-sparse kernels walk.  Row-uniform top-k
(the same count for every query row) is the paper's §5.2 load-balance
constraint; it is also what gives the kernels a static shape.

Ties: force-keep writes +inf into several blocks, and ``torch.topk``
breaks ties differently from ``lax.top_k``.  Every kept +inf block is kept
by both (nb_keep covers them), and entries that tie at NEG are invalid
and normalised after the sort, so the selected SETS and ``ok`` agree;
``torch.sort(stable=True)`` then gives the ascending order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG = -1e9


def keep_count(n: int, sparsity: float, minimum: int = 1) -> int:
    """Number of kept entries per row at a sparsity ratio (static)."""
    return max(minimum, int(round(n * (1.0 - sparsity))))


def row_topk_mask(scores: torch.Tensor, keep: int,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boolean mask keeping the top-``keep`` entries of each row; entries
    tied with the keep-th value are kept too.  Invalid entries never are."""
    s = scores if valid is None else torch.where(valid, scores, NEG)
    kth = torch.topk(s, keep, dim=-1).values[..., -1:]
    mask = s >= kth
    if valid is not None:
        mask = mask & valid
    return mask


def causal_block_valid(n_qb: int, n_kb: int, *, device=None) -> torch.Tensor:
    """(nQb, nKb): key block j visible to query block i iff j <= i."""
    qi = torch.arange(n_qb, device=device)[:, None]
    kj = torch.arange(n_kb, device=device)[None, :]
    return kj <= qi


def swa_block_valid(n_qb: int, n_kb: int, window_blocks: int, *,
                    device=None) -> torch.Tensor:
    qi = torch.arange(n_qb, device=device)[:, None]
    kj = torch.arange(n_kb, device=device)[None, :]
    return (kj <= qi) & (kj >= qi - window_blocks)


def _sorted_topk(s: torch.Tensor, nb_keep: int, n_kb: int, sort: bool):
    """Top-``nb_keep`` of the last axis, sorted ascending by index with the
    invalid (NEG-scored) picks pushed to the end."""
    vals, idx = torch.topk(s, nb_keep, dim=-1)
    ok = vals > NEG / 2
    if sort:
        key = torch.where(ok, idx, n_kb + 1)
        order = torch.sort(key, dim=-1, stable=True).indices
        idx = torch.gather(idx, -1, order)
        ok = torch.gather(ok, -1, order)
    return idx, ok


def block_topk_indices(block_scores: torch.Tensor, nb_keep: int, *,
                       causal: bool = True, window_blocks: int = 0,
                       local_blocks: int = 1, sort: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select ``nb_keep`` key blocks per query-block row.

    block_scores: (B, nQb, nKb).  Returns (idx, ok): (B, nQb, nb_keep)
    int32 / bool.  The diagonal ``local_blocks`` are always kept, which
    also guarantees every query row a live key in its first visited block.
    """
    b, n_qb, n_kb = block_scores.shape
    dev = block_scores.device
    valid = torch.ones((n_qb, n_kb), dtype=torch.bool, device=dev)
    if causal:
        valid &= causal_block_valid(n_qb, n_kb, device=dev)
    if window_blocks:
        valid &= swa_block_valid(n_qb, n_kb, window_blocks, device=dev)
    qi = torch.arange(n_qb, device=dev)[:, None]
    kj = torch.arange(n_kb, device=dev)[None, :]
    if causal:
        local = (kj <= qi) & (kj > qi - local_blocks - 1)
    elif n_qb == n_kb:
        local = (kj - qi).abs() <= local_blocks // 2
    else:
        local = torch.zeros((n_qb, n_kb), dtype=torch.bool, device=dev)
    s = torch.where(valid[None], block_scores, NEG)
    s = torch.where(local[None], float("inf"), s)          # force-keep local
    idx, ok = _sorted_topk(s, nb_keep, n_kb, sort)
    fill = torch.clamp(qi, max=n_kb - 1).expand(n_qb, nb_keep)[None]
    idx = torch.where(ok, idx, fill)
    return idx.to(torch.int32), ok


def decode_block_topk_indices(block_scores: torch.Tensor, nb_keep: int, *,
                              kv_len: torch.Tensor, block_k: int,
                              local: int = 64, sort: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode-step block selection over the pooled score cache.

    block_scores: (B, nKb) scores of the current query against each cache
    block; kv_len: (B,) valid cache length.  Blocks overlapping the
    trailing ``local`` tokens are force-kept; blocks entirely past kv_len
    are never kept.  Returns (idx, ok): (B, nb_keep) int32 / bool, sorted
    ascending, with invalid entries at index 0.
    """
    b, n_kb = block_scores.shape
    kb = torch.arange(n_kb, device=block_scores.device)[None, :]
    kvl = kv_len[:, None]
    valid = kb * block_k < kvl
    recent = ((kb + 1) * block_k > kvl - local) & valid
    s = torch.where(valid & ~recent, block_scores,
                    torch.where(recent, float("inf"), NEG))
    idx, ok = _sorted_topk(s, nb_keep, n_kb, sort)
    idx = torch.where(ok, idx, 0)
    return idx.to(torch.int32), ok
