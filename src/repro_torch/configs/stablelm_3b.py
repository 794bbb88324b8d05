"""StableLM-3B — dense, MHA (kv == q heads) [hf:stabilityai/stablelm-2]."""
from repro_torch.configs.base import ArchConfig, DSAConfig

CONFIG = ArchConfig(
    name="stablelm_3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab=50304, rope_theta=1e4,
    dsa=DSAConfig(enabled=True, sparsity=0.90, sigma=0.25, quant_bits=4),
)
