"""Jamba-1.5-Large (398B) — hybrid Mamba + attention 1:7 interleave, MoE 16e
top-2 every other layer [arXiv:2403.19887]."""
from repro_torch.configs.base import (ArchConfig, DSAConfig, MambaConfig,
                                      MoEConfig)

CONFIG = ArchConfig(
    name="jamba_1_5_large", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    attn_layer_period=8, attn_layer_offset=4,   # 1 attn per 8 layers
    moe=MoEConfig(num_experts=16, top_k=2, layer_period=2, layer_offset=1),
    dsa=DSAConfig(enabled=True, sparsity=0.90, sigma=0.25, quant_bits=4),
)
