"""Sparse-pattern construction (paper §3.1, §5.1, §5.2).

Token-granularity row top-k and threshold masks (the paper's fine-grained
patterns), 1xR column-vector structured masks (paper Table 4 / Fig 9),
the block index lists the block-sparse kernels walk, and the oracle and
metrics of the paper's analysis (Table 1, Fig 4-6).  Row-uniform top-k
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


def threshold_mask(weights: torch.Tensor, theta: float,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paper Table 1 oracle: drop attention WEIGHTS (post-softmax) below
    theta."""
    mask = weights >= theta
    if valid is not None:
        mask = mask & valid
    return mask


def vector_mask(scores: torch.Tensor, rows_per_vec: int, keep_vecs: int,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1xR column-vector structured mask (paper Fig 9): prune at the
    granularity of R consecutive ROWS sharing one column."""
    *lead, lq, lk = scores.shape
    if lq % rows_per_vec:
        raise ValueError(f"{lq} rows are not a multiple of {rows_per_vec}")
    s = scores if valid is None else torch.where(valid, scores, NEG)
    g = s.reshape(*lead, lq // rows_per_vec, rows_per_vec, lk).amax(dim=-2)
    mask = row_topk_mask(g, keep_vecs).repeat_interleave(rows_per_vec,
                                                         dim=-2)
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


def chunk_block_topk_indices(block_scores: torch.Tensor, nb_keep: int, *,
                             q_block_offset: torch.Tensor,
                             local_blocks: int = 1, sort: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-prefill block selection: ``block_topk_indices`` with the query
    blocks at a per-row GLOBAL offset.

    block_scores: (B, nQb, nKb) scores of a C-token chunk's query blocks
    against every cache key block; q_block_offset: (B,) the global index of
    each row's first chunk query block.  Block-causal validity and the
    local force-keep use the global query block ``q_block_offset + i``, so
    a chunk at depth p selects what the matching rows of a whole-prompt
    ``block_topk_indices`` would.  Kept indices are sorted ascending;
    invalid entries carry the clamped diagonal block and ``ok`` False.
    """
    b, n_qb, n_kb = block_scores.shape
    dev = block_scores.device
    qi = (torch.arange(n_qb, device=dev)[None, :, None]
          + q_block_offset.long()[:, None, None])
    kj = torch.arange(n_kb, device=dev)[None, None, :]
    valid = kj <= qi                                    # block-causal
    local = valid & (kj > qi - local_blocks - 1)
    s = torch.where(valid, block_scores, NEG)
    s = torch.where(local, float("inf"), s)             # force-keep local
    idx, ok = _sorted_topk(s, nb_keep, n_kb, sort)
    fill = torch.clamp(qi, min=0, max=n_kb - 1).expand(b, n_qb, nb_keep)
    idx = torch.where(ok, idx, fill)
    return idx.to(torch.int32), ok


def dequant_topk_scores(s_int: torch.Tensor, scale: torch.Tensor, *,
                        block_k: int = 1) -> torch.Tensor:
    """Dequantize int8-selection scores just before the top-k reduction.

    s_int: (..., n) int32 accumulator of an int8 x int8 selection product;
    scale: broadcastable per-(row, key) product of the query-row and
    key-row scales.  ``block_k`` folds in the block-mean normalisation of
    the pooled ``ktb`` scores.  Selection only ranks, so this is the one
    point where the int8 path returns to float."""
    s = s_int.float() * scale
    return s / block_k if block_k != 1 else s


def block_mask_from_indices(idx: torch.Tensor, valid: torch.Tensor,
                            n_kb: int) -> torch.Tensor:
    """Dense (B, nQb, nKb) boolean block mask of a block index list."""
    onehot = torch.nn.functional.one_hot(idx.long(), n_kb).bool()
    return (onehot & valid[..., None]).any(dim=-2)


def expand_block_mask(bmask: torch.Tensor, block_q: int, block_k: int
                      ) -> torch.Tensor:
    """(B, nQb, nKb) block mask -> (B, Lq, Lk) token mask."""
    return bmask.repeat_interleave(block_q, dim=-2).repeat_interleave(
        block_k, dim=-1)


# -- oracle and metrics (paper Table 1, Fig 4/5/6) ----------------------------


def oracle_topk_mask(attn_weights: torch.Tensor, keep: int,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-k over the TRUE attention weights: the paper's oracle
    pattern."""
    return row_topk_mask(attn_weights, keep, valid)


def prediction_accuracy(pred_mask: torch.Tensor, oracle_mask: torch.Tensor
                        ) -> torch.Tensor:
    """Fraction of predicted-kept positions that are oracle-kept (paper
    §4.3's prediction accuracy)."""
    hit = (pred_mask & oracle_mask).sum()
    return hit / pred_mask.sum().clamp(min=1)


def attention_sparsity(weights: torch.Tensor, theta: float) -> torch.Tensor:
    """Fraction of attention weights below theta (paper Table 1
    sparsity)."""
    return (weights < theta).float().mean()
