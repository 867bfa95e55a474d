"""zamba2-1.2b [hybrid] — 38L d=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64. Mamba2 backbone + SHARED attention block applied every 6th
layer (one weight copy, per-invocation KV caches). [arXiv:2411.15242; hf]
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=8192,
    vocab_size=32000,
    hybrid_period=6,
    ssm_state=64,
    ssm_conv=4,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_chunk=256,
)
