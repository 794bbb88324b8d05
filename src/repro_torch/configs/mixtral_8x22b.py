"""Mixtral-8x22B — MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.configs.base import ArchConfig, DSAConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral_8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=32768, swa_window=4096, rope_theta=1e6,
    moe=MoEConfig(num_experts=8, top_k=2),
    dsa=DSAConfig(enabled=True, sparsity=0.90, sigma=0.25, quant_bits=4),
)
