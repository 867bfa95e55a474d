"""deepseek-moe-16b [moe] — 28L d=2048 16H (kv=16) expert d_ff=1408
vocab=102400; 2 shared + 64 routed top-6, fine-grained; first layer dense
(d_ff=10944). [arXiv:2401.06066; hf]
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=10944,  # dense first layer
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_k_dense=1,
)
