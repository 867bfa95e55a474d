"""command-r-plus-104b [dense] — 64L d=12288 96H (GQA kv=8) d_ff=33792
vocab=256000. GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=33792,
    vocab_size=256000,
    rope_theta=8000000.0,
    use_bias=False,
)
