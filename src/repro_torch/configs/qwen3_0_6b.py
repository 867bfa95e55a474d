"""qwen3-0.6b [dense] — 28L d=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
qk_norm, GQA, tied embeddings, head_dim=128. [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=3072,
    vocab_size=151936,
    rope_theta=1000000.0,
    qk_norm=True,
    tie_embeddings=True,
)
