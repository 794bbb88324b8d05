"""DeepSeek-V3 (671B): multi-head latent attention and a mixture of
experts, 1 shared + 256 routed experts, top-8, the first 3 layers dense
[arXiv:2412.19437].  (The multi-token prediction head is omitted, as in
the reference.)"""
from repro_torch.configs.base import ArchConfig, DSAConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek_v3", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432, vocab=129280, rope_theta=1e4,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, first_k_dense=3),
    dsa=DSAConfig(enabled=True, sparsity=0.90, sigma=0.25, quant_bits=4),
)
