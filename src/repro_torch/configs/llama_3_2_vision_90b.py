"""llama-3.2-vision-90b [vlm] — 100L d=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
The vision frontend is a STUB: input_specs supplies precomputed patch
embeddings [B, 1601, 1280] (CLIP-ViT-H grid 40x40+1), projected to d_model.
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500000.0,
    cross_attn_period=5,
    n_ctx_tokens=1601,
    d_ctx=1280,
)
