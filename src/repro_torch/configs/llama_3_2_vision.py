"""Llama-3.2-11B-Vision — text backbone with a gated cross-attention
image layer in every group of 5; the vision tower is a stub (the model
takes precomputed patch embeddings) [hf:meta-llama/Llama-3.2-11B-Vision]."""
from repro_torch.configs.base import ArchConfig, DSAConfig

CONFIG = ArchConfig(
    name="llama_3_2_vision", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256, rope_theta=5e5,
    cross_attn_period=5, n_image_tokens=1601,
    dsa=DSAConfig(enabled=True, sparsity=0.90, sigma=0.25, quant_bits=4),
)
