"""command-r-35b [dense] — 40L d=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22528,
    vocab_size=256000,
    rope_theta=8000000.0,
    use_bias=False,
)
