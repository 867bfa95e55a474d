"""mamba2-1.3b [ssm] — 48L d=2048 attention-free, vocab=50280, ssm_state=128.
SSD (state-space duality). [arXiv:2405.21060; unverified]
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=32,  # unused (attention-free)
    n_kv_heads=32,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_chunk=256,
)
