"""Qwen1.5-110B — dense GQA with QKV bias [hf:Qwen/Qwen1.5-110B family]."""
from repro_torch.configs.base import ArchConfig, DSAConfig

CONFIG = ArchConfig(
    name="qwen1_5_110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=49152, vocab=152064, qkv_bias=True, rope_theta=1e6,
    dsa=DSAConfig(enabled=True, sparsity=0.90, sigma=0.25, quant_bits=4),
)
