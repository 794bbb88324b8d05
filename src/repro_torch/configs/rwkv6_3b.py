"""RWKV6 (Finch) 3B — attention-free, data-dependent decay
[arXiv:2404.05892].  DSA does not apply (no QK^T score matrix)."""
from repro_torch.configs.base import ArchConfig, DSAConfig, RWKVConfig

CONFIG = ArchConfig(
    name="rwkv6_3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab=65536,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64),
    dsa=DSAConfig(enabled=False),
)
