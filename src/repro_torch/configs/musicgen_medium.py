"""musicgen-medium [audio] — 48L d=1536 24H (kv=24) d_ff=6144 vocab=2048.
Decoder-only over EnCodec tokens; the EnCodec frontend is a STUB (the token
stream IS the codec codebook stream, vocab 2048). [arXiv:2306.05284; hf]
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_head=64,
    d_ff=6144,
    vocab_size=2048,
)
