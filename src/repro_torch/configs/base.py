"""Architecture configuration (the port's own copy of the dense-GQA,
sliding-window and RWKV6 subset).

Each architecture is an ``ArchConfig`` in its own module
(``repro_torch/configs/<id>.py``) exposing ``CONFIG``.  ``get_config(name)``
resolves by id; ``reduced(cfg)`` gives the CPU-test variant of the same
family, with exactly the widths the JAX reference's ``reduced`` picks.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64            # wkv state is head_dim x head_dim per head
    decay_lora: int = 64          # low-rank data-dependent decay


@dataclasses.dataclass(frozen=True)
class DSAConfig:
    """Dynamic Sparse Attention (the paper's technique).

    sparsity: fraction of attention weights dropped (paper: 0.90 - 0.99).
    sigma:    k/d random-projection scale.
    quant_bits: prediction-path fake-quant precision (paper: INT4 default).
    block_q/block_k: block granularity of prediction and selection.
    """
    enabled: bool = False
    sparsity: float = 0.90
    sigma: float = 0.25
    quant_bits: int = 4           # 2 | 4 | 8 | 16 | 32 (32 = no quant)
    block_q: int = 128
    block_k: int = 128
    lambda_mse: float = 0.01      # joint-loss weight of L_MSE (paper Eq. 7)
    min_blocks: int = 1           # always keep >=1 block per query row
    local_blocks: int = 1         # always keep the diagonal (local) block(s)
    sort_indices: bool = True     # visit kept blocks in ascending order


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | ssm (RWKV6)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    swa_window: int = 0           # 0 = full attention; else sliding-window size
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    rwkv: Optional[RWKVConfig] = None
    dsa: DSAConfig = dataclasses.field(default_factory=DSAConfig)
    dtype: str = "bfloat16"       # activation dtype
    param_dtype: str = "bfloat16"
    # training memory policy: recompute each layer group in the backward
    # pass ("full"), keeping the unbatched products' outputs ("dots"), or
    # keep every activation ("none")
    remat: bool = True
    remat_policy: str = "full"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


ARCH_IDS = ("yi_6b", "stablelm_3b", "qwen1_5_110b", "h2o_danube_1_8b",
            "rwkv6_3b")


def get_config(name: str) -> ArchConfig:
    name = name.replace("-", "_")
    if name not in ARCH_IDS:
        raise ValueError(f"arch {name!r} is not ported; ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=64, n_heads=4, head_dim=16,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128, vocab=512,
        swa_window=min(cfg.swa_window, 64) if cfg.swa_window else 0,
        remat=False, dtype="float32", param_dtype="float32",
    )
    if cfg.rwkv is not None:
        kw["rwkv"] = RWKVConfig(head_dim=16, decay_lora=8)
    if cfg.dsa.enabled:
        kw["dsa"] = dataclasses.replace(cfg.dsa, block_q=16, block_k=16)
    return dataclasses.replace(cfg, **kw)
