"""kimi-k2-1t-a32b [moe] — 61L d=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840; 384 routed experts top-8 + 1 shared; first layer dense
(d_ff=18432). Trillion-parameter MoE (paper-table). [arXiv:2501.kimi2; unverified]
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=18432,  # dense first layer
    vocab_size=163840,
    n_experts=384,
    n_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    first_k_dense=1,
)
