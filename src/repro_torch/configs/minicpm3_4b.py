"""minicpm3-4b [dense] — 62L d=2560 40H (kv=40) d_ff=6400 vocab=73448 — MLA.
[hf:openbmb/MiniCPM3-4B; hf]
Multi-head latent attention: q_lora=768, kv_lora=256, nope=64, rope=32, v=64;
decode uses the absorbed (latent-space) form with the compressed cache.
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_head=64,
    d_ff=6400,
    vocab_size=73448,
    attn_type="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
)
